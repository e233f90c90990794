"""The simulator's observability in the port against the JAX package's:
the sim cases of tests/test_tracing.py (span digests and journeys),
tests/test_flight.py (a flaky-cloud breach's flight bundle, byte-identical
across same-seed runs) and tests/test_kernel_observatory.py (the kernels
section equal across same-seed runs, outside `sim.harness.VOLATILE` in the
port's leg, and zero steady recompiles) run on both packages with their own
assertions (tests/torch_twins.py), and each simulator run's event log,
digest and report outside `sim.harness.DEVICE_SPECIFIC` must be equal.
The kernels section's dispatch counts are held against the reference's
pinned to the device in tests/test_torch_sim_port.py."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

CASES = [("test_tracing", c) for c in tw.cases("test_tracing", ["TestSimDeterminism"])]
CASES += [("test_flight", c) for c in tw.cases("test_flight", ["TestFlakyCloudDeterminism"])]
CASES += [("test_kernel_observatory", c)
          for c in tw.cases("test_kernel_observatory", ["TestSimReportDeterminism"])]


@pytest.mark.parametrize("name, case", CASES)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
