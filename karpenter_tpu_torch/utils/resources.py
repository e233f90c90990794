"""Resource-list arithmetic over plain dicts of float.

The equivalent of the reference's pkg/utils/resources (Fits/Merge/Subtract/
Cmp over corev1.ResourceList). Quantities are floats in canonical units:
cpu in cores, memory/storage in bytes, pods/extended resources in counts.
`parse_quantity` accepts Kubernetes quantity strings ("100m", "1Gi").
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping

ResourceList = dict[str, float]

_DECIMAL_SUFFIXES = {
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "": 1.0,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
}
_BINARY_SUFFIXES = {
    "Ki": 2**10,
    "Mi": 2**20,
    "Gi": 2**30,
    "Ti": 2**40,
    "Pi": 2**50,
    "Ei": 2**60,
}
_QUANTITY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)([A-Za-z]*)$")


def parse_quantity(value: str | int | float) -> float:
    """Parse a Kubernetes quantity string into a float in canonical units."""
    if isinstance(value, (int, float)):
        return float(value)
    m = _QUANTITY_RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    number, suffix = m.groups()
    if suffix in _BINARY_SUFFIXES:
        return float(number) * _BINARY_SUFFIXES[suffix]
    if suffix in _DECIMAL_SUFFIXES:
        return float(number) * _DECIMAL_SUFFIXES[suffix]
    raise ValueError(f"invalid quantity suffix {suffix!r} in {value!r}")


def parse_resource_list(raw: Mapping[str, str | int | float]) -> ResourceList:
    return {k: parse_quantity(v) for k, v in raw.items()}


def merge(*resource_lists: Mapping[str, float]) -> ResourceList:
    """Element-wise sum; missing keys are zero (reference resources.Merge)."""
    out: ResourceList = {}
    for rl in resource_lists:
        for k, v in rl.items():
            out[k] = out.get(k, 0.0) + v
    return out


def subtract(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    """a - b over a's keys ONLY (reference resources.Subtract keeps LHS keys
    — a nodepool with no limits stays unlimited after subtracting usage)."""
    return {k: v - b.get(k, 0.0) for k, v in a.items()}


def subtract_into(a: Mapping[str, float], b: Mapping[str, float]) -> ResourceList:
    """a - b over the union of keys (reference resources.SubtractFrom)."""
    out: ResourceList = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, 0.0) - v
    return out


def scale(rl: Mapping[str, float], factor: float) -> ResourceList:
    return {k: v * factor for k, v in rl.items()}


def fits(candidate: Mapping[str, float], total: Mapping[str, float]) -> bool:
    """True if every requested resource fits in `total`.

    Missing keys in `total` are zero, so a request for an extended resource
    the node doesn't expose fails (reference resources.Fits semantics).
    """
    return all(v <= total.get(k, 0.0) + 1e-9 for k, v in candidate.items() if v > 0)


def cmp(a: Mapping[str, float], b: Mapping[str, float]) -> bool:
    """True if a <= b element-wise over a's keys."""
    return fits(a, b)


def max_resources(*resource_lists: Mapping[str, float]) -> ResourceList:
    """Element-wise max (used for init-container request folding)."""
    out: ResourceList = {}
    for rl in resource_lists:
        for k, v in rl.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def is_zero(rl: Mapping[str, float]) -> bool:
    return all(abs(v) < 1e-12 for v in rl.values())


def non_negative(rl: Mapping[str, float]) -> ResourceList:
    return {k: max(0.0, v) for k, v in rl.items()}


def keys(*resource_lists: Mapping[str, float]) -> set[str]:
    out: set[str] = set()
    for rl in resource_lists:
        out.update(rl.keys())
    return out


def format_cpu(cores: float) -> str:
    if cores == int(cores):
        return str(int(cores))
    return f"{int(round(cores * 1000))}m"


def format_memory(num_bytes: float) -> str:
    for suffix, mult in (("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
        if num_bytes >= mult and num_bytes % mult == 0:
            return f"{int(num_bytes // mult)}{suffix}"
    return str(int(num_bytes))
