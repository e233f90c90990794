"""One run of one cell: set-up, the measured window, the judge, the result.

`run_cell` is the whole run but for the look for a card, so the CPU tests
can drive it on a CPU engine; `main` adds that look and prints.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass

from benchmark.harness import spec as specmod
from benchmark.harness.trace import Tracer
from benchmark.reference import OutOfScope

FORBIDDEN = ("jax", "jaxlib", "flax", "karpenter_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


@dataclass
class Run:
    """What a metric reader reads."""

    workload: str
    setup_s: float
    units: list  # (seconds, work done, failures) per timed unit
    tracer: Tracer


def run_cell(spec: specmod.Spec, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device=None) -> dict:
    """One run; returns the result line's fields (and `stderr`: the lines
    to print last on standard error)."""
    cell = spec.workload(workload)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    e2e = spec.end_to_end(workload)
    layer = spec.per_layer(workload)
    readers = {m["name"]: spec.reader(m["name"]) for m in (layer if trace else e2e)}
    tracer = Tracer(trace)
    drv = specmod.loop(traffic["loop"]).Loop(config, traffic, seed, device, tracer)
    cuda = _cuda(device)
    drv.setup()
    install_hooks(tracer, readers.values())
    if cuda:
        import torch

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    tracer.start()
    drv.run(seconds)
    if cuda:
        torch.cuda.synchronize()
    tracer.stop()
    tracer.restore()
    window_s = time.perf_counter() - t_window
    device_info = _device(cuda, cell.get("chips", 1))
    found = forbidden_modules()
    run = Run(workload, setup_s, drv.units, tracer)
    metrics = {}
    for m in (layer if trace else e2e):
        v = readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted, failed = drv.attempted()
    notes = drv.notes()
    drv.finish()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    try:
        verdict = drv.judge()
    except OutOfScope as e:  # the reference cannot judge this cell: not correct
        tracer.notes.append(f"the reference is out of its scope: {e}")
        verdict = {"checks": {"reference_in_scope": {"value": 1, "limit": 0}}, "compared": 0,
                   "reference_solves": 0, "reference_s": 0.0}
    checks = verdict["checks"]
    correct = bool(attempted) and verdict["compared"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if trace and tracer.device is not None:
        dt = tracer.device
        out["device"]["busy_s"] = dt.busy_s
        out["device"]["window_s"] = dt.window_s
        out["breakdown"] = {"device_ops": dt.top_ops(), "idle_gaps": dt.idle_gaps()}
    out["checks"] = checks
    out["forbidden_modules"] = found
    secs = sorted(u[0] * 1e3 for u in drv.units) or [0.0]
    out["stderr"] = notes + tracer.notes + [
        "units ms: p10 %.2f, p50 %.2f, p90 %.2f, max %.2f" % tuple(
            secs[min(len(secs) - 1, int(q * len(secs)))] for q in (0.1, 0.5, 0.9, 1.0)),
        f"window {window_s:.3f} s, {attempted} units, reference {verdict['reference_s']:.3f} s over "
        f"{verdict['compared']} compared units ({verdict['reference_solves']} reference solves)",
    ] + [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    return out


def install_hooks(tracer: Tracer, readers) -> None:
    """Wrap each program function the readers name once per span, with
    the first recorder a reader gives for it and CUDA events if any asks:
    readers that share a span share its records."""
    hooks: dict = {}
    for r in readers:
        for span, target in getattr(r, "SPANS", {}).items():
            _, rec, events = hooks.get(span, (target, None, False))
            hooks[span] = (target, rec or getattr(r, f"record_{span}", None),
                           events or span in getattr(r, "CUDA_EVENTS", ()))
    for span, (target, rec, events) in hooks.items():
        tracer.wrap(span, target, rec, cuda_events=events)


def _cuda(device) -> bool:
    if device is not None and str(device) == "cpu":
        return False
    import torch

    return torch.cuda.is_available()


def _device(cuda: bool, chips: int) -> dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i) for i in range(chips)),
    }
