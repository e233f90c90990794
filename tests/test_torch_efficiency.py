"""The port's efficiency observatory (observability/efficiency.py) against
the JAX package's, on the CPU.

The reference's tests/test_efficiency.py cases that need no AOT compiler,
operator or jax executable, on both packages: the host-stall timeline of
batches, report_section, the cost tables fed stand-in executables, the
utilization join, and the device profiler's capture, cooldown and degraded
modes (each package with its own profiler: jax.profiler in the reference,
torch.profiler here — the port's capture writes a Chrome trace). Then the
port's own parts: the H100 peaks row, found only once CUDA is initialized,
and the profiler's activities.
"""

from __future__ import annotations

import json
import os
import sys
import time

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_delta import JAX, PORT, _m  # noqa: E402

PKGS = [JAX, PORT]


class Pkg:
    def __init__(self, pkg: str):
        self.name = pkg
        self.eff = _m(pkg, "observability.efficiency")
        self.kobs = _m(pkg, "observability.kernels")
        self.ktime = _m(pkg, "tracing.kernel")
        self.FakeClock = _m(pkg, "utils.clock").FakeClock
        self.metrics = _m(pkg, "metrics").global_registry


def _wait(prof):
    deadline = time.monotonic() + 10.0
    while prof.snapshot()["active"] and time.monotonic() < deadline:
        time.sleep(0.02)


@pytest.fixture
def clean():
    """Both packages' efficiency state reset before and after."""
    def reset():
        for pkg in PKGS:
            p = Pkg(pkg)
            _wait(p.eff.profiler())
            p.kobs.registry().reset()
            p.eff.tables().reset()
            p.eff.profiler().configure(profile_dir="")
            p.eff.profiler().reset()

    reset()
    yield
    reset()


def twin(fn):
    seen = {pkg: fn(Pkg(pkg)) for pkg in PKGS}
    assert seen[PORT] == seen[JAX]
    return seen[PORT]


class BrokenExe:
    def cost_analysis(self):
        raise RuntimeError("backend without cost models")


class PartialExe:
    """cost_analysis yields bytes only, memory_analysis missing."""

    def cost_analysis(self):
        return [{"bytes accessed": 4096.0}]

    def memory_analysis(self):
        raise NotImplementedError


class FullExe:
    """1e9 operations, 1e7 bytes: at 1e12 and 1e11 a second, compute-bound
    at 1 ms."""

    def cost_analysis(self):
        return {"flops": 1e9, "bytes accessed": 1e7}


# -- the host-stall timeline --------------------------------------------------------


def test_host_twin_never_counts_device_busy(clean):
    def run(p):
        reg = p.kobs.registry()
        with reg.batch_scope(label="host-twin") as acc:
            reg.record_host("spec.twin", "8x4")
            reg.record_host("spec.twin", "8x4")
        assert acc["host_stall_fraction"] == 1.0 and acc["device_busy_s"] == 0.0
        return {k: acc[k] for k in ("dispatches", "fenced", "host_records", "timeline",
                                    "host_stall_fraction")}

    assert twin(run)["host_records"] == 2


def test_unfenced_dispatch_counts_but_not_busy(clean):
    """Outside a measure() context a named dispatch counts (the
    one-dispatch contract) but adds no busy time."""
    def run(p):
        reg = p.kobs.registry()
        p.ktime.dispatch(lambda: 1, kernel="spec.unfenced")
        with reg.batch_scope(label="unfenced") as acc:
            p.ktime.dispatch(lambda: 1, kernel="spec.unfenced")
        return acc["dispatches"], acc["fenced"], acc["device_busy_s"], acc["host_stall_fraction"]

    assert twin(run) == (1, 0, 0.0, 1.0)


def test_measured_batch_reconstruction(clean):
    """A fenced dispatch inside a batch: counted fenced, busy > 0, the
    split within the batch wall, its timeline event fenced."""
    def run(p):
        reg = p.kobs.registry()

        def work():
            time.sleep(0.002)
            return 1

        with reg.batch_scope(label="timeline") as acc:
            with p.ktime.measure() as m:
                p.ktime.dispatch(work, kernel="spec.tl")
        (event,) = acc["timeline"]
        assert acc["device_busy_s"] > 0 and acc["wall_s"] >= acc["device_busy_s"]
        assert 0.0 <= acc["host_stall_fraction"] <= 1.0
        assert m["enqueue_s"] + m["block_s"] <= m["compile_s"] + m["execute_s"] + 1e-6
        return acc["dispatches"], acc["fenced"], event["kernel"], event["fenced"], m["dispatches"]

    assert twin(run) == (1, 1, "spec.tl", True, 1)


def test_timeline_view_and_steady_counters(clean):
    def run(p):
        reg = p.kobs.registry()
        p.ktime.dispatch(lambda: 1, kernel="spec.view")
        reg.seal()
        with reg.batch_scope(label="steady-a"):
            with p.ktime.measure():
                p.ktime.dispatch(lambda: 1, kernel="spec.view")
        with reg.batch_scope(label="steady-b"):
            pass
        reg.unseal()
        view = reg.debug_snapshot(view="timeline")
        st = view["steady"]
        assert 0.0 <= st["host_stall_fraction"] <= 1.0
        return ({k: st[k] for k in ("steady_batches", "device_batches", "host_only_batches",
                                    "device_dispatches")},
                [b["label"] for b in view["batches"]], all("timeline" in b for b in view["batches"]))

    got = twin(run)
    assert got == ({"steady_batches": 2, "device_batches": 1, "host_only_batches": 1,
                    "device_dispatches": 1}, ["steady-a", "steady-b"], True)


def test_report_section_delta_and_exact_one(clean):
    def run(p):
        reg = p.kobs.registry()
        with reg.batch_scope(label="warmup"):
            pass
        assert reg.efficiency_counters()["steady_batches"] == 0
        empty = p.eff.report_section(p.eff.snapshot_base())
        base = p.eff.snapshot_base()
        reg.seal()
        with reg.batch_scope(label="host-only"):
            reg.record_host("spec.sect", "4")
        reg.unseal()
        return empty, p.eff.report_section(base)

    empty, section = twin(run)
    assert empty["steady_batches"] == 0 and empty["host_stall_fraction"] is None
    assert section["steady_batches"] == section["host_only_batches"] == 1
    assert section["host_stall_fraction"] == 1.0 and section["utilization"] == {}


# -- cost tables and utilization (stand-in executables) ------------------------------


def test_cost_tables_degrade_and_keep_what_they_got(clean, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("KARPENTER_TPU_PEAK_BYTES", "1e11")

    def run(p):
        eff = p.eff
        assert eff.note_executable("spec.a", "1", BrokenExe()) is None
        assert eff.note_executable("spec.b", "2", BrokenExe()) is None
        calls = eff.tables().stats()["analysis_calls"]
        assert eff.note_executable("spec.a", "1", BrokenExe()) is None
        assert eff.tables().stats()["analysis_calls"] == calls
        part = eff.note_executable("spec.part", "4", PartialExe())
        full = eff.note_executable("spec.mm", "16x16", FullExe(), scope="mesh=8:pods")
        again = eff.note_executable("spec.mm", "16x16", FullExe(), scope="mesh=8:pods")
        return part, full, again, eff.tables().stats(), eff.tables().lookup("spec.mm", "16x16"), \
            eff.tables().table()

    part, full, again, stats, lookup, table = twin(run)
    assert part == {"bytes_accessed": 4096.0, "floor_s": 4096.0 / 1e11}
    assert full["floor_s"] == pytest.approx(1e-3) and again == full == lookup
    assert stats == {"entries": 2, "analysis_calls": 4, "errors": 2}


def test_sidecar_rides_the_executable_cache(clean, tmp_path):
    def run(p):
        cache = _m(p.name, "aot.cache").ExecutableCache(str(tmp_path / p.name))
        p.eff.note_executable("spec.mm", "16x16", FullExe(), cache=cache, key="k" * 64)
        fresh = p.eff.CostTables()
        entry = fresh.note_executable("spec.mm", "16x16", BrokenExe(), cache=cache, key="k" * 64)
        return entry, fresh.stats()["analysis_calls"], \
            json.load(open(tmp_path / p.name / ("k" * 64 + ".cost.json")))

    entry, calls, sidecar = twin(run)
    assert calls == 0 and entry == sidecar and entry["flops"] == 1e9


def test_utilization_joins_cost_and_measured(clean, monkeypatch):
    monkeypatch.setenv("KARPENTER_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("KARPENTER_TPU_PEAK_BYTES", "1e11")

    def run(p):
        assert p.eff.utilization_view() == {}

        def work(x):
            time.sleep(0.004)  # a mean execute wall above the 1 ms floor
            return x

        with p.ktime.measure():
            p.ktime.dispatch(work, torch.ones(16, 16), kernel="spec.util")
        p.eff.note_executable("spec.util", "16x16", FullExe())
        view = p.eff.publish_utilization()
        row = view["spec.util"]["16x16"]
        assert row["utilization"] == pytest.approx(row["floor_s"] / row["mean_execute_s"], abs=1e-5)
        gauge = p.metrics.get("karpenter_kernel_utilization")
        assert gauge.value({"kernel": "spec.util", "bucket": "16x16"}) == pytest.approx(row["utilization"])
        cv = p.eff.cost_view()
        assert p.eff.cost_view(kernel="missing") is None
        assert p.kobs.registry().debug_snapshot(kernel="missing", view="cost") is None
        return row["floor_s"], row["samples"], [r["kernel"] for r in cv["rows"]], cv["cost_tables"]

    assert twin(run) == (1e-3, 1, ["spec.util"], {"entries": 1, "analysis_calls": 1, "errors": 0})


def test_peak_env_overrides_and_malformed_values(clean, monkeypatch):
    def run(p):
        monkeypatch.setenv("KARPENTER_TPU_PEAK_FLOPS", "1e12")
        monkeypatch.setenv("KARPENTER_TPU_PEAK_BYTES", "1e11")
        set_ = p.eff._device_peaks()
        floor = p.eff._floor_seconds({"flops": 1e12, "bytes_accessed": 1e10})
        monkeypatch.setenv("KARPENTER_TPU_PEAK_FLOPS", "400T")
        monkeypatch.setenv("KARPENTER_TPU_PEAK_BYTES", "-5")
        bad = p.eff._device_peaks()
        return set_, floor, bad

    set_, floor, bad = twin(run)
    assert set_ == (1e12, 1e11) and floor == pytest.approx(1.0)
    assert bad == Pkg(PORT).eff.DEFAULT_PEAKS  # no device up: the host default


# -- the device profiler ------------------------------------------------------------


def test_profiler_disabled_returns_none(clean):
    def run(p):
        prof = p.eff.profiler()
        return prof.capture(0.1), prof.arm("slo:x"), prof.snapshot()["enabled"]

    assert twin(run) == (None, None, False)


def test_profiler_capture_writes_files_and_counts(clean, tmp_path):
    def run(p):
        prof = p.eff.profiler().configure(profile_dir=str(tmp_path / p.name))
        ctr = p.metrics.get("karpenter_profiler_captures_total")
        base = ctr.value({"trigger": "debug"})
        record = prof.capture(0.0, trigger="debug")
        files = [os.path.join(r, fn) for r, _, fs in os.walk(record["path"]) for fn in fs]
        assert files, "capture produced no trace files"
        return record["name"], "error" in record, ctr.value({"trigger": "debug"}) - base

    assert twin(run) == ("device-0001-debug", False, 1.0)


def test_port_capture_is_a_chrome_trace(clean, tmp_path):
    """The port's capture exports torch.profiler's Chrome trace, which
    parses as JSON and holds the work done while it ran."""
    prof = Pkg(PORT).eff.profiler().configure(profile_dir=str(tmp_path))
    assert prof.activities() == ["cpu"]  # no card here
    record = prof.arm("debug", seconds=0.3, cooldown=0)
    for _ in range(50):
        torch.ones(64) + 1
    _wait(prof)
    (done,) = prof.snapshot()["recent"]
    assert done["trace"] == os.path.join(record["path"], "trace.json")
    with open(done["trace"]) as f:
        assert isinstance(json.load(f)["traceEvents"], list)


def test_profiler_arm_cooldown_and_busy_slot(clean, tmp_path):
    def run(p):
        clock = p.FakeClock()
        prof = p.eff.profiler().configure(clock=clock, profile_dir=str(tmp_path / p.name))
        first = prof.arm("slo:obj", seconds=0.0)
        clock.step(10.0)
        inside = prof.arm("slo:obj", seconds=0.0)
        clock.step(p.eff.CAPTURE_COOLDOWN)
        _wait(prof)
        second = prof.arm("slo:obj", seconds=0.0)
        _wait(prof)
        prof.reset()
        again = prof.arm("slo:obj", seconds=0.0)
        _wait(prof)
        return first["name"], inside, second["name"], again["name"]

    assert twin(run) == ("device-0001-slo-obj", None, "device-0002-slo-obj", "device-0001-slo-obj")


def test_profiler_degraded_modes(clean, tmp_path):
    def run(p):
        blocker = tmp_path / f"{p.name}-file"
        blocker.write_text("not a dir")
        prof = p.eff.profiler().configure(profile_dir=str(blocker / "nested"))
        unwritable = (prof.arm("slo:x"), prof.capture(0.0), prof.snapshot()["active"])
        prof.configure(profile_dir=str(tmp_path / p.name))
        prof._available = False  # a process without a working profiler
        try:
            unavailable = (prof.enabled, prof.capture(0.1), prof.arm("slo:x"))
        finally:
            prof._available = None
        return unwritable, unavailable

    assert twin(run) == (
        (None, {"error": "capture already in progress or dir unwritable"}, False),
        (False, None, None),
    )


def test_port_profiler_reports_cuda_activity_with_a_card(monkeypatch):
    prof = Pkg(PORT).eff.DeviceProfiler()
    assert prof.available()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert prof.activities() == ["cpu", "cuda"]


# -- the port's peaks: one H100 row -------------------------------------------------


def test_h100_peaks_row(monkeypatch):
    """The rates PERF.md's bounds use: 16.73e12 32-bit integer operations a
    second and 3.35e12 bytes a second, found by the card's name only once
    CUDA is initialized; no TPU row."""
    eff = Pkg(PORT).eff
    monkeypatch.delenv("KARPENTER_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("KARPENTER_TPU_PEAK_BYTES", raising=False)
    assert eff.DEVICE_PEAKS == (("h100", 16.73e12, 3.35e12),)
    assert eff._device_peaks() == eff.DEFAULT_PEAKS == (5e10, 2e10)
    names = []
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: names.append(1) or "NVIDIA H100 80GB HBM3")
    assert eff._device_peaks() == eff.DEFAULT_PEAKS and names == []  # never initializes CUDA
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert eff._device_peaks() == (16.73e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA A100-SXM4-80GB")
    assert eff._device_peaks() == eff.DEFAULT_PEAKS
    monkeypatch.setenv("KARPENTER_TPU_PEAK_BYTES", "2e12")
    assert eff._device_peaks() == (eff.DEFAULT_PEAKS[0], 2e12)
