#!/usr/bin/env python3
"""Run one cell of the benchmark of karpenter_tpu_torch once, on the cards
of this machine, and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

`--trace 0` measures the cell's end-to-end metrics, `--trace 1` its
per-layer metrics (spans, counters and a torch.profiler trace of the
window). The cells, configurations, traffic mixes and metrics are those
BENCHMARK.json names, found by name under this folder. Exits non-zero and
prints no result without a CUDA card (or fewer than the cell asks for),
or if JAX or the JAX package was loaded. Kernel libraries build once per
checkout into the port's `_build/`; torch's extension build directory
and Triton's cache are kept under `benchmark/_cache/`.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = os.path.join(ROOT, "benchmark", "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    sys.path.insert(0, ROOT)

    from benchmark.harness import cell as cellmod
    from benchmark.harness.spec import Spec

    spec = Spec(ROOT)
    chips = spec.workload(args.workload).get("chips", 1)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    out = cellmod.run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), T_START)
    found = out.pop("forbidden_modules")
    lines = out.pop("stderr")
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
