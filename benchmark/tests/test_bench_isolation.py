"""What a run loads and reads: no JAX, no JAX package, nothing of the
JAX benchmark; the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.tests.bench_helpers import ROOT

RUN = r"""
import json, pathlib, sys
sys.path.insert(0, {root!r})
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and isinstance(args[0], str) else None)
from benchmark.tests.bench_helpers import run, tiny_root
out = run(tiny_root(pathlib.Path({tmp!r})), {workload!r}, trace={trace})
print(json.dumps({{"correct": out["correct"], "forbidden": out["forbidden_modules"],
                  "top": sorted({{m.split(".")[0] for m in sys.modules}}), "opened": opened}}))
"""


@pytest.mark.parametrize("workload,trace", [("burst50k", False), ("churn10k", True)])
def test_a_run_loads_no_jax_and_reads_no_jax_benchmark(tmp_path, workload, trace):
    code = RUN.format(root=ROOT, tmp=str(tmp_path), workload=workload, trace=trace)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "USE_FLAX": "0"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["correct"] and got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "karpenter_tpu", "chip_smoke", "bench"} & set(got["top"])
    assert "karpenter_tpu_torch" in got["top"]
    names = [p.rsplit("/", 1)[-1] for p in got["opened"]]
    assert not [n for n in names if n == "bench.py" or n.startswith(("BENCH_", "MULTICHIP_"))]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.catalog, benchmark.reference.provisioning, "
            "benchmark.reference.quantity\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    top = set(eval(proc.stdout))  # noqa: S307 — a list of names printed above
    assert not {"karpenter_tpu_torch", "karpenter_tpu", "jax", "jaxlib", "torch"} & top


def test_a_run_without_a_card_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, f"{ROOT}/benchmark/run.py", "--workload", "burst50k", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
