"""The fake kube-scheduler (`controllers/binding.py`) and node health
(`controllers/node/health.py`) in the port against the JAX package's:
every case of tests/test_binding.py and tests/test_node_health.py runs on
both packages with its own assertions (tests/torch_twins.py), and every
FakeClock store's objects at the end of a case must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


MODULES = ["test_binding", "test_node_health"]


@pytest.mark.parametrize(
    "name, case", [(name, case) for name in MODULES for case in tw.cases(name)]
)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
