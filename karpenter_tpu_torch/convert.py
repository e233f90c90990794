"""Carry a CatalogEngine's encoded state across from host arrays.

The encoded catalog is this system's counterpart of a model's weights: the
per-row compat matrices, the offering tables and the vocabulary tables.
`engine_state_from_numpy` takes them as numpy arrays — from either package's
engine, under the reference's attribute names or this package's — and
returns them as tensors on `device`, so the same state can feed both
packages' kernels.

`scan_operands_from_numpy` does the same for the fused scan's 27 operands
(ops/fused.py builds them; the reference's packer.solve_scan_fn takes the
same arrays), so the port's scan and the reference's read the same state.

The scan's loop state crosses over too: the reference carries 23
components (seven scalars, then 16 arrays; `packer.solve_scan_full_fn`
returns them, `solve_scan_resume_fn` takes them), the port the seven scalars
in one int32 vector `scal` (its 8th entry the last launch's iteration
count) and the same 16 arrays as tensors. `scan_state_from_numpy` and
`scan_state_to_numpy` map between the two layouts, and
`group_core_from_numpy` takes the group residency's [cap, 3] core matrix.
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


# the fused scan's operands in the reference's order and dtypes
# (karpenter_tpu/ops/packer.py _scan_program): int8 trans_kind, one byte
# per bool, float64 resources, 0-d int32 n_pods / n_nodes
SCAN_OPERANDS = (
    ("pod_gi", torch.int32), ("claim_pad", torch.int32),
    ("g_req", torch.float64), ("g_floor", torch.float64),
    ("uniq_alloc", torch.float64), ("usage0", torch.float64),
    ("tol", torch.bool), ("open_ok", torch.bool), ("open_fam", torch.int32),
    ("open_uok", torch.bool), ("trans_kind", torch.int8),
    ("trans_fam", torch.int32), ("famu_ok", torch.bool),
    ("n_pods", torch.int32), ("n_nodes", torch.int32),
    ("node_ok", torch.bool), ("node_rem0", torch.float64),
    ("fam_mask", torch.bool), ("tmpl_mask", torch.bool),
    ("open_cand", torch.bool), ("uid_onehot", torch.bool),
    ("uid_of_type", torch.int32), ("cap_f", torch.float64),
    ("pool_of_t", torch.int32), ("pool_rem0", torch.float64),
    ("pool_has", torch.bool), ("pool_bad", torch.bool),
)

_NP_DTYPES = {
    torch.int32: np.int32, torch.int64: np.int64, torch.int8: np.int8,
    torch.float64: np.float64, torch.bool: np.bool_,
}


def scan_operands_from_numpy(args, device) -> tuple:
    """The 27 scan operands (numpy arrays or scalars, in the reference's
    layout) → a tuple of contiguous tensors on `device`, each in the
    reference's dtype. An operand that is already a tensor on `device` in
    that dtype passes through. A value that the dtype cannot hold exactly
    raises."""
    if len(args) != len(SCAN_OPERANDS):
        raise ValueError(f"expected {len(SCAN_OPERANDS)} scan operands, got {len(args)}")
    device = torch.device(device)
    out = []
    for (name, dtype), a in zip(SCAN_OPERANDS, args):
        if isinstance(a, torch.Tensor):
            if a.dtype != dtype or a.device.type != device.type:
                raise ValueError(f"{name}: tensor {a.dtype} on {a.device}, expected {dtype} on {device}")
            out.append(a.contiguous())
            continue
        arr = np.asarray(a)
        want = _NP_DTYPES[dtype]
        conv = arr.astype(want)
        if not np.array_equal(conv, arr):
            raise ValueError(f"{name}: values not exactly representable as {dtype}")
        out.append(torch.from_numpy(conv.copy(order="C")).to(device))
    return tuple(out)


# the 16 array components of the scan's loop state, after the seven
# scalars, in the reference's order (karpenter_tpu/ops/packer.py _scan_init)
SCAN_STATE_ARRAYS = (
    ("queue", torch.int32), ("last_len", torch.int32), ("pod_claim", torch.int32),
    ("pod_node", torch.int32), ("pod_seq", torch.int32), ("claim_ti", torch.int32),
    ("claim_fam", torch.int32), ("claim_count", torch.int32), ("claim_key", torch.int64),
    ("u_valid", torch.bool), ("rem", torch.float64), ("cfit", torch.bool),
    ("nptr", torch.int32), ("node_rem", torch.float64), ("tm_st", torch.bool),
    ("pool_rem", torch.float64),
)
# the seven scalars head, tail, stop, abort, seqc, done, nclaims: stop is a
# bool in the reference, the others int32
_SCALAR_DTYPES = (np.int32, np.int32, np.bool_, np.int32, np.int32, np.int32, np.int32)


def _exact(name: str, arr: np.ndarray, want) -> np.ndarray:
    conv = arr.astype(want)
    if not np.array_equal(conv, arr):
        raise ValueError(f"{name}: values not exactly representable as {np.dtype(want)}")
    return conv


def scan_state_from_numpy(state, device) -> tuple:
    """The reference's 23 state components (numpy arrays or scalars) → the
    port's (scal, 16 tensors) on `device`. scal's iteration count starts
    at 0."""
    if len(state) != 7 + len(SCAN_STATE_ARRAYS):
        raise ValueError(f"expected {7 + len(SCAN_STATE_ARRAYS)} state components, got {len(state)}")
    device = torch.device(device)
    scal = np.zeros(8, dtype=np.int32)
    for k in range(7):
        scal[k] = _exact(f"state[{k}]", np.asarray(state[k]), np.int32)
    out = [torch.from_numpy(scal).to(device)]
    for (name, dtype), a in zip(SCAN_STATE_ARRAYS, state[7:]):
        arr = _exact(name, np.asarray(a), _NP_DTYPES[dtype])
        out.append(torch.from_numpy(np.ascontiguousarray(arr)).to(device))
    return tuple(out)


def scan_state_to_numpy(state) -> tuple:
    """The port's (scal, 16 tensors) → the reference's 23 numpy components,
    each in the reference's dtype (0-d arrays for the scalars)."""
    if len(state) != 1 + len(SCAN_STATE_ARRAYS):
        raise ValueError(f"expected {1 + len(SCAN_STATE_ARRAYS)} state tensors, got {len(state)}")
    scal = state[0].cpu().numpy()
    out = [np.asarray(scal[k]).astype(dt) for k, dt in enumerate(_SCALAR_DTYPES)]
    out += [t.cpu().numpy() for t in state[1:]]
    return tuple(out)


def group_core_from_numpy(core, device) -> torch.Tensor:
    """A resident [cap, 3] group-solve core matrix (choice, feasible,
    pods-per-node) → an int32 tensor on `device`."""
    arr = np.asarray(core)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"core must be [cap, 3], got {arr.shape}")
    return torch.from_numpy(np.ascontiguousarray(_exact("core", arr, np.int32))).to(torch.device(device))
