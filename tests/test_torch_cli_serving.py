"""`python -m karpenter_tpu_torch` and the serving endpoints in the port
against the JAX package's: every case of tests/test_cli_serving.py runs on
both packages with its own assertions (tests/torch_twins.py); the port's
binary gets `--device cpu`, in process and as a subprocess."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_cli_serving"))
def test_cli_serving_case_on_both_packages(case):
    tw.twin("test_cli_serving", case)
