"""NodeOverlays (`apis/nodeoverlay.py`, `cloudprovider/overlay.py`,
`controllers/nodeoverlay.py`) and instance selection through the operator
in the port against the JAX package's: every case of
tests/test_nodeoverlay.py and tests/test_instance_selection_oracle.py runs
on both packages with its own assertions (tests/torch_twins.py), and the
records must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


MODULES = ["test_nodeoverlay", "test_instance_selection_oracle"]


@pytest.mark.parametrize(
    "name, case", [(name, case) for name in MODULES for case in tw.cases(name)]
)
def test_case_on_both_packages(name, case):
    tw.twin(name, case)
