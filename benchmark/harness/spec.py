"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its file under `configs/`, as the entry's
`file` gives it) and a traffic mix (`traffic/<name>.json`); each metric of
the cell has a reader `metrics/<name>.py` (per-layer metrics) and each
traffic mix names its loop (`loops/<name>.py`). Adding a cell, a
configuration, a mix or a per-layer metric is adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Spec:
    def __init__(self, root: str, doc: dict | None = None):
        self.root = root
        if doc is None:
            with open(os.path.join(root, "BENCHMARK.json")) as f:
                doc = json.load(f)
        self.doc = doc
        self.bench_dir = os.path.join(root, "benchmark")

    def workload(self, name: str) -> dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.doc["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.bench_dir, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def _applies(self, metric: dict, workload: str, e2e_names: set) -> bool:
        if "workloads" in metric:
            return workload in metric["workloads"]
        return metric.get("moves") in e2e_names if "moves" in metric else True

    def end_to_end(self, workload: str) -> list:
        return [m for m in self.doc["end_to_end"] if self._applies(m, workload, set())]

    def per_layer(self, workload: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.doc["per_layer"] if self._applies(m, workload, e2e)]

    def reader(self, metric: str):
        path = os.path.join(self.bench_dir, "metrics", f"{metric}.py")
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def loop(name: str):
    return importlib.import_module(f"benchmark.loops.{name}")
