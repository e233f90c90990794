"""The port's simulator against the JAX package's: every case of
tests/test_sim_fleet.py (the simulator's fleet: three tenant cells on a two-replica solver pool, one replica killed mid-run) runs on both packages with its own
assertions (tests/torch_twins.py; a line that states a fact of the
reference's host route runs in the port's leg as `torch_twins.PORT_LINES`
gives it). The port's engines are built on the CPU. Each simulator run
records its event-log digest, its event log and its report outside
`sim.harness.DEVICE_SPECIFIC`, and the two packages' records must be
equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_sim_fleet"))
def test_case_on_both_packages(case):
    tw.twin("test_sim_fleet", case)
