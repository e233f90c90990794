"""Kubernetes quantities as floats in canonical units (cores, bytes):
the number times its suffix's factor, as the Kubernetes API defines them."""

from __future__ import annotations

import re

GIB = float(2**30)
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}
_DECIMAL = {"m": 1e-3, "": 1.0, "k": 1e3, "M": 1e6, "G": 1e9, "T": 1e12}
_RE = re.compile(r"^([0-9]*\.?[0-9]+)([A-Za-z]*)$")


def parse(value) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    m = _RE.match(value.strip())
    if not m:
        raise ValueError(f"invalid quantity {value!r}")
    number, suffix = m.groups()
    if suffix in _BINARY:
        return float(number) * _BINARY[suffix]
    if suffix in _DECIMAL:
        return float(number) * _DECIMAL[suffix]
    raise ValueError(f"invalid quantity suffix in {value!r}")
