"""The reconciler harness (`operator/harness.py`) in the port against the
JAX package's: the cases of tests/test_harness.py that need only that
module — the backoff limiter, the circuit breaker and the reconciler
harness's isolation — run on both packages with their own assertions
(tests/torch_twins.py). Its other cases need `operator/operator.py` and the
cloud-provider wrappers, which the port does not have yet."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

HARNESS_ONLY = ["TestBackoffRateLimiter", "TestCircuitBreaker", "TestHarnessIsolation"]


@pytest.mark.parametrize("case", tw.cases("test_harness", HARNESS_ONLY))
def test_harness_case_on_both_packages(case):
    tw.twin("test_harness", case)
