#!/usr/bin/env python3
"""The controls: each cell's reference with one guarantee of its
configuration broken, put in the program's place and judged as a run
judges the program. Each must read as not correct.

    python3 benchmark/controls/control.py --workload <name> --seed <n> [--seed <n> ...]

Provisioning cells: the reference packing without counting pod slots (a
node's pods would not fit what it can give them, one slot each).

Prints one JSON line a seed: the number compared and its limit. Plain
NumPy: it needs no card and imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WINDOW_PASSES = 500  # about a churn window's passes at run_seconds = 51


def provisioning_kept(traffic: dict, config: dict, seed: int, window_passes: int) -> tuple:
    """The demands of the passes a run of `window_passes` compares, as the
    loop evolves the pending set (warm-up passes first)."""
    from benchmark.harness.traffic import PodTraffic, compared

    gen = PodTraffic(config["pods"], traffic, seed)
    pending = gen.backlog()
    kept = []
    warm = traffic["warmup_passes"]
    batch = traffic["arrivals"]["kind"] == "batch"
    for k in range(warm + window_passes):
        pending.extend(gen.arrivals(k))
        if k >= warm and compared(traffic, seed, k, len(kept)):
            kept.append(list(pending))
            if batch:
                break  # every pass brings the same batch
        del pending[:gen.departures(pending)]
    return gen.shapes, kept


def control_reading(spec, workload: str, seed: int, window_passes: int = WINDOW_PASSES) -> dict:
    from benchmark.harness import judge

    cell = spec.workload(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    if traffic["loop"] == "provisioning":
        shapes, demands = provisioning_kept(traffic, config, seed, window_passes)
        control = judge.provisioning_reference(config, ignore_pod_slots=True)
        kept = [(d, control.solve(judge.reference_pods(shapes, d))) for d in demands]
        verdict = judge.judge_provisioning(config, shapes, kept)
    else:
        raise ValueError(f"no control for loop {traffic['loop']!r}")
    return {"workload": workload, "seed": seed, "compared": verdict["compared"],
            "checks": verdict["checks"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness.spec import Spec

    spec = Spec(ROOT)
    for seed in args.seed:
        print(json.dumps(control_reading(spec, args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
