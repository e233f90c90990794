"""The write-ahead intent journal (`runtime/journal.py`) and leader
election (`operator/leaderelection.py`) in the port against the JAX
package's: every case of tests/test_journal.py and
tests/test_leaderelection.py runs on both packages with its own
assertions (tests/torch_twins.py); the leader identities are drawn from
one seeded source, and the Operators' passes, events and stores must be
equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


MODULES = ["test_journal", "test_leaderelection"]


@pytest.mark.parametrize(
    "name, case", [(name, case) for name in MODULES for case in tw.cases(name)]
)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
