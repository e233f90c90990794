"""The solver service's wire under faults, in the port against the JAX
package's: every case of tests/test_transport_faults.py (torn and corrupt
frames, poisoned connections, replay through a corrupt reply) runs on both
packages with its own assertions (tests/torch_twins.py)."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_transport_faults"))
def test_transport_faults_case_on_both_packages(case):
    tw.twin("test_transport_faults", case)
