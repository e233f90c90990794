"""Crash recovery from the intent journal and restart resume in the port
against the JAX package's: the cases of tests/test_recovery.py that need
no simulator (`sim/`, not in the port yet) and every case of
tests/test_restart_resume.py run on both packages with their own
assertions (tests/torch_twins.py), and the Operators' passes, events and
stores must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

# these cases import the simulator (karpenter_tpu.sim) in the case itself
NEEDS_SIM = {
    "TestIdempotentLaunch::test_ack_then_raise_retry_converges_on_one_instance",
    "TestCrashSimDeterminism::test_same_seed_crash_runs_are_byte_identical",
    "TestCrashSimDeterminism::test_crash_free_run_reports_zero_recovery",
}
CASES = [("test_recovery", c) for c in tw.cases("test_recovery") if c not in NEEDS_SIM]
CASES += [("test_restart_resume", c) for c in tw.cases("test_restart_resume")]


@pytest.mark.parametrize("name, case", CASES)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
