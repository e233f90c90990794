"""Carry a CatalogEngine's encoded state across from host arrays.

The encoded catalog is this system's counterpart of a model's weights: the
per-row compat matrices, the offering tables and the vocabulary tables.
`engine_state_from_numpy` takes them as numpy arrays — from either package's
engine, under the reference's attribute names or this package's — and
returns them as tensors on `device`, so the same state can feed both
packages' kernels.
"""

from __future__ import annotations

import numpy as np
import torch

# accepted names (the reference engine's private attributes carry a leading
# underscore) -> the dtype each is held in on the device
_DTYPES = {
    "req_compat": torch.bool,
    "offer_compat": torch.bool,
    "offering_custom_need": torch.bool,
    "offering_available": torch.bool,
    "offering_owner": torch.int32,
    "allocatable": torch.float64,
    "slot_key": torch.int32,
    "value_int": torch.int32,
}


def engine_state_from_numpy(arrays: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """{name: array} → {name: tensor on device}. `owner_onehot` ([O, I]
    bool, one owner per offering) is accepted in place of
    `offering_owner` and converted to owner indices. allocatable stays
    float64 (byte-scale memory must compare exactly)."""
    out: dict[str, torch.Tensor] = {}
    for raw_name, arr in arrays.items():
        name = raw_name.lstrip("_")
        arr = np.asarray(arr)
        if name == "owner_onehot":
            if arr.ndim != 2 or not np.all(arr.sum(axis=1) == 1):
                raise ValueError("owner_onehot must have exactly one owner per offering")
            name, arr = "offering_owner", np.argmax(arr, axis=1)
        dtype = _DTYPES.get(name)
        if dtype is None:
            raise KeyError(f"unknown engine state array {raw_name!r}")
        if dtype is torch.bool:
            arr = arr.astype(bool)
        elif dtype is torch.int32:
            if arr.dtype == np.uint32:
                arr = arr.view(np.int32)
            elif not np.all((arr >= np.iinfo(np.int32).min) & (arr <= np.iinfo(np.int32).max)):
                raise ValueError(f"{raw_name}: values outside int32")
            arr = arr.astype(np.int32)
        else:
            arr = arr.astype(np.float64)
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return out
