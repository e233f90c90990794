"""Runs on a card: each cell for a short window through `run.py`, and the
controls at the cells' own sizes. Skipped without a CUDA card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.bench_helpers import ROOT

pytestmark = pytest.mark.cuda


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("workload", ["burst50k", "churn10k"])
def test_cell_runs_correct_on_the_card(workload):
    _card()
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "4294967311",
         "--seconds", "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu" and list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", ["burst50k", "churn10k"])
def test_control_at_the_cells_size_is_not_correct(workload):
    _card()
    from benchmark.controls.control import control_reading
    from benchmark.harness.spec import Spec

    check = control_reading(Spec(ROOT), workload, 2718281828)["checks"]["decision_mismatch"]
    assert check["value"] > check["limit"]
