"""The provisioning suite's oracle specs in the port against the JAX
package's: every case of tests/test_provisioning_oracle.py runs on both
packages with its own assertions (tests/torch_twins.py). The port's
Provisioner gets `default_engine_factory(device="cpu")`; each run records
the decisions of every `Env.schedule` and, for every provisioner harness,
the NodeClaim objects in its store, the pod nominations and the events —
and the two packages' records must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_provisioning_oracle"))
def test_provisioning_oracle_case_on_both_packages(case):
    tw.twin("test_provisioning_oracle", case)
