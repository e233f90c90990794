"""Crash recovery from the intent journal and restart resume in the port
against the JAX package's: every case of tests/test_recovery.py (its
crash simulations included) and of tests/test_restart_resume.py runs on
both packages with its own assertions (tests/torch_twins.py), and the
Operators' passes, events and stores, and the simulations' event logs,
digests and reports outside `sim.harness.DEVICE_SPECIFIC`, must be
equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

CASES = [("test_recovery", c) for c in tw.cases("test_recovery")]
CASES += [("test_restart_resume", c) for c in tw.cases("test_restart_resume")]


@pytest.mark.parametrize("name, case", CASES)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
