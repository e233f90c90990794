"""Whole runs of the cells on CPU engines at small sizes: correct when
the program is sound, not correct with the timed path broken underneath
or with the control in the program's place; a cell, a configuration and a
per-layer metric added as files and entries alone."""

from __future__ import annotations

import json
import os

import pytest

from benchmark.controls.control import control_reading
from benchmark.harness.spec import Spec
from benchmark.tests.bench_helpers import CONFIG, load, run, save, tiny_root

CELLS = ["burst50k", "churn10k"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_is_correct_on_cpu(tmp_path, workload):
    out = run(tiny_root(tmp_path), workload)
    assert out["correct"], out["stderr"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"} and len(out["metrics"]) == 2
    assert list(out)[-3] == "checks"  # last in the line; the caller pops the other two


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_host_side_metrics(tmp_path, workload):
    out = run(tiny_root(tmp_path), workload, trace=True)
    assert out["correct"]
    want = {"burst50k": "scheduler_build_ms.burst", "churn10k": "pass_ms_p50.churn"}[workload]
    assert want in out["metrics"]
    # no device here: the device's metrics are left out, never read as 0
    assert not any("idle" in m or "roofline" in m or "device" in m for m in out["metrics"])
    assert out["device"]["busy_s"] == 0.0 and out["device"]["window_s"] > 0


def _half_batch(monkeypatch):
    from karpenter_tpu_torch.scheduler.scheduler import Scheduler

    real_solve = Scheduler.solve

    def solve(self, pods, *a, **kw):
        return real_solve(self, list(pods)[: len(pods) // 2], *a, **kw)

    monkeypatch.setattr(Scheduler, "solve", solve)


def _altered_answer(monkeypatch):
    from karpenter_tpu_torch.scheduler.scheduler import Scheduler

    real_solve = Scheduler.solve

    def solve(self, pods, *a, **kw):
        results = real_solve(self, pods, *a, **kw)
        if results.new_node_claims:
            claim = results.new_node_claims[0]
            claim.instance_type_options = claim.instance_type_options[1:]
        return results

    monkeypatch.setattr(Scheduler, "solve", solve)


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer], ids=["half_batch", "altered_answer"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, workload, fault):
    fault(monkeypatch)
    out = run(tiny_root(tmp_path), workload)
    assert not out["correct"]
    assert out["checks"]["decision_mismatch"]["value"] > out["checks"]["decision_mismatch"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tmp_path, workload):
    reading = control_reading(Spec(tiny_root(tmp_path, batch=1500, backlog=1500)), workload, 2718281828,
                              window_passes=40)
    check = reading["checks"]["decision_mismatch"]
    assert reading["compared"] > 0 and check["value"] > check["limit"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, and their entries: no file of the harness is edited."""
    root = tiny_root(tmp_path)
    bench = os.path.join(root, "benchmark")
    cfg = load(os.path.join(bench, "configs", CONFIG))
    cfg["name"] = "kwok144-dummy"
    save(os.path.join(bench, "configs", "kwok144-dummy.json"), cfg)
    save(os.path.join(bench, "traffic", "dummy.json"), {
        "loop": "provisioning", "backlog": 0, "arrivals": {"pods": 300, "kind": "batch"},
        "departures": "all", "warmup_passes": 1, "options": {}, "compare": {"one_in": 1, "max": 100}})
    with open(os.path.join(bench, "metrics", "solves.dummy.py"), "w") as f:
        f.write('"""solves.dummy: timed solves in the window."""\n\n\ndef read(run):\n'
                '    return float(len(run.units))\n')
    doc = load(os.path.join(root, "BENCHMARK.json"))
    doc["configs"].append({"name": "kwok144-dummy", "source": "https://example.org/dummy",
                           "file": "benchmark/configs/kwok144-dummy.json", "reduced": [], "why": "a test"})
    doc["workloads"].append({"name": "dummy.burst", "config": "kwok144-dummy", "traffic": "dummy",
                             "chips": 1, "why": "a test"})
    for m in doc["end_to_end"]:
        if m["name"] == "pods_per_s":
            m["workloads"].append("dummy.burst")
    doc["per_layer"].append({"name": "solves.dummy", "unit": "solves", "better": "higher",
                             "source": "host_clock", "layer": "Scheduler", "moves": "pods_per_s",
                             "workloads": ["dummy.burst"]})
    save(os.path.join(root, "BENCHMARK.json"), doc)
    out = run(root, "dummy.burst")
    assert out["correct"] and set(out["metrics"]) == {"setup_s", "pods_per_s"}
    traced = run(root, "dummy.burst", trace=True)
    assert traced["correct"] and traced["metrics"]["solves.dummy"]["value"] == traced["attempted"]
    assert json.dumps(traced)  # one JSON line
