"""Drift (`controllers/nodeclaim/disruption.py` with
`nodepool_controllers.HashController`) and NodePool validation
(`ValidationController`) in the port against the JAX package's: every case
of tests/test_drift_oracle.py and tests/test_validation_oracle.py runs on
both packages with its own assertions (tests/torch_twins.py), and every
FakeClock store's objects at the end of a case must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


MODULES = ["test_drift_oracle", "test_validation_oracle"]


@pytest.mark.parametrize(
    "name, case", [(name, case) for name in MODULES for case in tw.cases(name)]
)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
