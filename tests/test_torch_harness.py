"""The reconciler harness (`operator/harness.py`), the cloud-provider
circuit breaker and the operator's health surfaces in the port against the
JAX package's: every case of tests/test_harness.py runs on both packages
with its own assertions (tests/torch_twins.py) — the backoff limiter, the
circuit breaker, the harness's isolation of a plain exception, and the
Operator wired with its wrappers."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_harness"))
def test_harness_case_on_both_packages(case):
    tw.twin("test_harness", case)
