"""The node-claim lifecycle, garbage collection, termination and the
node-pool controllers in the port against the JAX package's: every case of
tests/test_lifecycle.py runs on both packages with its own assertions
(tests/torch_twins.py), and every FakeClock store's objects at the end of
a case must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_lifecycle"))
def test_lifecycle_case_on_both_packages(case):
    tw.twin("test_lifecycle", case)
