"""The arithmetic of the metrics on fixed inputs: the rate, the
whole-window percentile, the spread, the scan's roofline and the reduction
of a device trace."""

from __future__ import annotations

import statistics

import numpy as np
import pytest

from benchmark.harness import peaks, probes, stats
from benchmark.harness.trace import DeviceTrace


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_is_numpys_linear(q):
    xs = [0.113, 0.092, 0.35, 0.101, 0.099, 0.12, 0.087, 0.094, 0.2, 0.091, 0.095]
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_rate_is_all_work_over_all_time():
    assert stats.rate(4 * 50_000, 0.5 + 0.6 + 0.55 + 0.65) == pytest.approx(200_000 / 2.3)
    with pytest.raises(ValueError):
        stats.rate(10, 0.0)


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [86000.0, 87000.0, 88000.0, 85000.0, 86500.0, 87500.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_scan_roofline_at_the_main_paths_shapes():
    # PERF.md §6, B14: 50,000 steps over G=128 groups, U=36 rows, D=4 dims,
    # no nodes; one instruction an operation at 64 a clock an SM
    ops = peaks.scan_ops(50_000, 128, 36, 4, 0)
    assert ops == 50_000 * (128 * 36 * 4 + 2 * 36 * 4)
    assert peaks.OPS_PER_S == pytest.approx(16.73e12, rel=1e-3)
    assert peaks.scan_bound_s(50_000, 128, 36, 4, 0, 10_000_000) * 1e3 == pytest.approx(0.05596, rel=1e-3)
    # bytes bound it when they outweigh the operations
    assert peaks.scan_bound_s(1, 1, 1, 1, 0, 3.35e9) == pytest.approx(1e-3)


def test_scan_bytes_and_groups_count_only_the_real_sizes():
    import torch

    P, Pb, G, Gb, Cb, D, U, T = 700, 1024, 20, 32, 256, 4, 3, 1
    pod_gi = torch.full((Pb,), -1, dtype=torch.int32)
    pod_gi[:P] = torch.arange(P, dtype=torch.int32) % G
    ops = [pod_gi, torch.zeros(Cb, dtype=torch.int32), torch.zeros(Gb, D, dtype=torch.float64),
           torch.zeros(Gb, D, dtype=torch.float64), torch.zeros(U, D, dtype=torch.float64),
           torch.zeros(D, dtype=torch.float64)] + [torch.zeros(T, Gb, dtype=torch.bool)] * 3 + [
        torch.zeros(T, Gb, U, dtype=torch.bool)] + [torch.zeros(1)] * 3 + [
        torch.tensor(P, dtype=torch.int32), torch.tensor(0, dtype=torch.int32)] + [torch.zeros(1, 1)] * 12
    pods_out = [torch.zeros(Pb, dtype=torch.int32)] * 3  # pod_claim, pod_node, pod_seq
    claims_out = [torch.zeros(Cb, dtype=torch.int32)] * 2 + [torch.zeros(Cb, U, dtype=torch.bool)]
    result = (torch.tensor(0), torch.tensor(9), *pods_out, *claims_out, torch.zeros(1, dtype=torch.bool),
              torch.zeros(1, 1), torch.tensor(P + 3))
    got = probes.resolve(probes.scan_call(((1, False, False), tuple(ops)), {}, result))
    assert (got["G"], got["U"], got["D"], got["N"], got["steps"]) == (G, U, D, 0, P + 3)
    operands = (P * 4 + 9 * 4 + 2 * G * D * 8 + U * D * 8 + D * 8 + 3 * T * G + T * G * U
                + 3 * 4 + 2 * 4 + 12 * 4)  # the three [1] operands, the two scalars, the dummies
    outputs = 8 + 8 + 3 * P * 4 + 2 * 9 * 4 + 9 * U + 1 + 4 + 8
    want = operands + outputs
    assert got["bytes"] == want


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_device_trace_busy_idle_and_gaps():
    events = [
        _x("unit", "user_annotation", 0, 100), _x("solve", "user_annotation", 10, 80),
        _x("fused_decode", "user_annotation", 60, 30),
        _x("k_scan", "kernel", 20, 30), _x("Memcpy HtoD", "gpu_memcpy", 45, 10),
        _x("unit", "user_annotation", 200, 50), _x("k_scan", "kernel", 210, 10),
        _x("k_outside", "kernel", 150, 20),  # between units: not counted
        _x("gc", "user_annotation", 120, 25),  # a collection the next unit pays for
        _x("gc", "user_annotation", 30, 5),  # one inside a unit
    ]
    dt = DeviceTrace(events, {"unit", "solve", "fused_decode", "gc"})
    assert dt.window_s == pytest.approx(175e-6)
    assert dt.busy_s == pytest.approx((35 + 10) * 1e-6)  # 20-55 and 210-220
    assert dt.op_seconds(lambda n: "scan" in n) == pytest.approx(40e-6)
    assert dt.top_ops()[0] == ["k_scan", pytest.approx(40e-6)]
    gaps = dt.idle_gaps()
    assert gaps[0] == ["fused_decode", pytest.approx(45e-6)]  # 55-100, the decode open at 77.5
    assert ["solve", pytest.approx(20e-6)] in gaps  # 0-20: unit and solve open at 10
    assert ["unit", pytest.approx(30e-6)] in gaps  # 220-250
    assert ["gc", pytest.approx(25e-6)] in gaps  # 120-145, idle while the collector ran


def test_readers_sharing_a_span_install_one_wrapper():
    """Two readers that name one program function under one span wrap it
    once: each call leaves one record, with CUDA events if either asks."""
    import types

    from benchmark.harness import cell
    from benchmark.harness.trace import Tracer

    calls = []
    a = types.SimpleNamespace(SPANS={"spread": "benchmark.harness.stats:spread"},
                              record_spread=lambda args, kw, out: calls.append(out) or out)
    b = types.SimpleNamespace(SPANS={"spread": "benchmark.harness.stats:spread"}, CUDA_EVENTS=("spread",),
                              record_spread=lambda args, kw, out: out)
    tracer = Tracer(True)
    cell.install_hooks(tracer, [a, b])
    try:
        tracer.active = True
        stats.spread([1.0, 2.0, 3.0])
    finally:
        tracer.active = False
        tracer.restore()
    assert len(tracer.records["spread"]) == 1 and len(calls) == 1 and len(tracer.spans["spread"]) == 1
    assert stats.spread.__module__ == "benchmark.harness.stats"  # restored
