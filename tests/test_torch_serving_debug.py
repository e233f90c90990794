"""The operator's debug endpoints (`operator/serving.py`) in the port
against the JAX package's: the cases of tests/test_serving_debug.py run on
both packages with their own assertions (tests/torch_twins.py), but those
that dispatch a jax program (the efficiency views' `_wired`); the device
profile's capture from the Operator runs the port's torch.profiler."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

# these cases compile and dispatch a jax.jit program in the case itself
NEEDS_JAX = {
    "TestKernelsEfficiencyViews::test_cost_view_and_drilldown",
    "TestKernelsEfficiencyViews::test_cost_view_unknown_kernel_404",
    "TestKernelsEfficiencyViews::test_timeline_view",
}


@pytest.mark.parametrize(
    "case", [c for c in tw.cases("test_serving_debug") if c not in NEEDS_JAX]
)
def test_serving_debug_case_on_both_packages(case):
    tw.twin("test_serving_debug", case)
