"""The operator's debug endpoints (`operator/serving.py`) in the port
against the JAX package's: every case of tests/test_serving_debug.py runs
on both packages with its own assertions (tests/torch_twins.py). The
efficiency views' `_wired` dispatches a plain callable in the port and
notes an executable of the port's AOT compiler as its cost entry
(`torch_twins.PORT_LINES`); the device profile's capture from the Operator
runs the port's torch.profiler."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

# every case runs on both packages: the cost and timeline views' jax
# program has the port's counterpart in PORT_LINES
NEEDS_JAX: set = set()


@pytest.mark.parametrize(
    "case", [c for c in tw.cases("test_serving_debug") if c not in NEEDS_JAX]
)
def test_serving_debug_case_on_both_packages(case):
    tw.twin("test_serving_debug", case)
