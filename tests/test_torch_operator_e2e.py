"""The operator's end-to-end loop in the port against the JAX package's:
every case of tests/test_operator_e2e.py (pending pods become kwok nodes,
drift replacement, consolidation), tests/test_expectations_e2e.py and
tests/test_chaos_guards.py runs on both packages with its own assertions
(tests/torch_twins.py). The port's Operator gets CPU engines; each run
records every pass's `run_once()` summary, each Operator's events and
reconcile errors, and every FakeClock store's objects — and the two
packages' records must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


MODULES = ["test_operator_e2e", "test_expectations_e2e", "test_chaos_guards"]


@pytest.mark.parametrize(
    "name, case", [(name, case) for name in MODULES for case in tw.cases(name)]
)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
