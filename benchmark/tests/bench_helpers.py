"""Shared set-up of the benchmark's tests: a copy of BENCHMARK.json and of
the benchmark's data files in a temporary root, cut to sizes a CPU run
holds, and a run of a cell there on CPU engines."""

from __future__ import annotations

import json
import os
import shutil
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def save(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


CONFIG = "kwok1008-generic.json"


def tiny_root(tmp_path, batch: int = 600, backlog: int = 500) -> str:
    """A root with BENCHMARK.json and the benchmark's configs, traffic and
    metric readers, the catalog not repeated, a burst of `batch` pods and a
    churn backlog of `backlog`."""
    root = str(tmp_path / "root")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, sub), os.path.join(root, "benchmark", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), os.path.join(root, "BENCHMARK.json"))
    cdir, tdir = os.path.join(root, "benchmark", "configs"), os.path.join(root, "benchmark", "traffic")
    cfg = load(os.path.join(cdir, CONFIG))
    cfg["catalog"]["repeat"] = 1
    cfg["pods"]["population"] = max(batch, backlog) * 2
    save(os.path.join(cdir, CONFIG), cfg)
    burst = load(os.path.join(tdir, "burst50k.json"))
    burst["arrivals"]["pods"] = batch
    save(os.path.join(tdir, "burst50k.json"), burst)
    churn = load(os.path.join(tdir, "churn10k.json"))
    churn["backlog"] = backlog
    save(os.path.join(tdir, "churn10k.json"), churn)
    return root


def run(root: str, workload: str, seed: int = 1234567890123, seconds: float = 1.0, trace: bool = False):
    from benchmark.harness import cell
    from benchmark.harness.spec import Spec

    return cell.run_cell(Spec(root), workload, seed, seconds, trace, time.perf_counter(), device="cpu")
