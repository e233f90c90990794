"""The disruption candidacy and disruption-cost specs in the port against the JAX package's: every case of
tests/test_candidate_oracle.py runs on both packages with its own assertions
(tests/torch_twins.py), a parametrized case once a parameter set. The
port's Provisioner gets `default_engine_factory(device="cpu")`; each run
records every Command the disruption controller parks or starts, every
provisioner harness's and disruption env's NodeClaims and events — and the
two packages' records must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_candidate_oracle"))
def test_candidate_oracle_case_on_both_packages(case):
    tw.twin("test_candidate_oracle", case)
