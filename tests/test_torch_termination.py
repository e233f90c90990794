"""Termination's eviction events and the cloud-provider metrics wrapper in
the port against the JAX package's: every case of
tests/test_termination_events_oracle.py and
tests/test_cloudprovider_metrics.py runs on both packages with its own
assertions (tests/torch_twins.py), and the records must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


MODULES = ["test_termination_events_oracle", "test_cloudprovider_metrics"]


@pytest.mark.parametrize(
    "name, case", [(name, case) for name in MODULES for case in tw.cases(name)]
)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
