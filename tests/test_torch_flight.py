"""The port's flight recorder (observability/flight.py, a copy of the
reference's) against the JAX package's, on the CPU.

Each scenario is one of the reference's tests/test_flight.py cases that needs
no operator, server or simulator, written against a package (its `flight`
module, its FakeClock, its metrics registry): it makes the reference's
assertions and returns what it saw — frames, snapshots, bundles (file bytes
and digests), reports. Every scenario runs on both packages, and what it
returns must be equal. The port's kernel registry serves a frame's
`kernels` source as the reference's does: its deterministic counts.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_metrics_exposition import parse_exposition  # noqa: E402
from test_torch_delta import JAX, PORT, _m  # noqa: E402


class Pkg:
    def __init__(self, pkg: str):
        self.name = pkg
        self.flight = _m(pkg, "observability.flight")
        self.FakeClock = _m(pkg, "utils.clock").FakeClock
        self.metrics = _m(pkg, "metrics").global_registry

    def recorder(self, **kw):
        kw.setdefault("clock", self.FakeClock())
        return self.flight.FlightRecorder(**kw)


def scrub_volatile(p: Pkg, tmp):
    frame = {"ok": 1, "last_batch_seconds": 0.5,
             "nested": {"compile_wall_s": 2.0, "keep": [{"device_memory": 1}]},
             "list": [{"joint_sweeps": 3, "x": "y"}]}
    out = p.flight.scrub(frame)
    assert out == {"ok": 1, "nested": {"keep": [{}]}, "list": [{"x": "y"}]}
    assert {"last_batch_seconds", "compile_wall_s", "execute_wall_s", "device_memory",
            "live_array_bytes"} <= p.flight.VOLATILE_KEYS
    return out, sorted(p.flight.VOLATILE_KEYS), p.flight.canonical(frame)


def record_sources_and_ring(p: Pkg, tmp):
    rec = p.recorder(capacity=3)
    rec.register_source("a", lambda: {"n": 1})
    rec.register_source("b", lambda: {"m": 2})
    rec.register_source("bad", lambda: 1 / 0)
    rec.register_source("b", lambda: {"m": 3})  # keyed replace
    frames = [rec.record("pass") for _ in range(5)]
    assert frames[0]["sources"]["b"] == {"m": 3}
    assert "ZeroDivisionError" in frames[0]["sources"]["bad"]["error"]
    snap = rec.snapshot()
    assert snap["ring_depth"] == 3 and snap["frames_recorded"] == 5
    assert [f["seq"] for f in rec._ring] == [3, 4, 5]
    return frames, snap


def reset_keeps_sources_and_config(p: Pkg, tmp):
    rec = p.recorder(capacity=7, flight_dir=str(tmp / "nope"))
    rec.register_source("s", lambda: {})
    rec.record("pass")
    rec.dump("x", cooldown=0.0)
    rec.reset()
    snap = rec.snapshot()
    assert snap["ring_depth"] == 0 and snap["frames_recorded"] == 0 and snap["bundles"] == []
    assert snap["capacity"] == 7 and snap["sources"] == ["s"]
    return {k: v for k, v in snap.items() if k != "flight_dir"}


def bundle_file_format_and_digest(p: Pkg, tmp):
    clock = p.FakeClock()
    rec = p.recorder(clock=clock, flight_dir=str(tmp))
    rec.register_source("s", lambda: {"v": 1, "last_batch_seconds": 9.9})
    rec.record("pass")
    clock.step(1.0)
    rec.record("pass")
    bundle = rec.dump("slo:avail")
    assert bundle["name"] == "flight-0001-slo-avail"
    data = open(bundle["path"]).read()
    lines = data.splitlines()
    header = json.loads(lines[0])
    assert header["bundle"] == bundle["name"] and header["frames"] == 2
    h = hashlib.sha256()
    for line in lines[1:]:
        h.update(line.encode())
        h.update(b"\n")
    assert header["sha256"] == "sha256:" + h.hexdigest()
    assert all("last_batch_seconds" not in line for line in lines[1:])
    return data, {k: v for k, v in bundle.items() if k != "path"}


def cooldown_dedupes_per_trigger(p: Pkg, tmp):
    clock = p.FakeClock()
    rec = p.recorder(clock=clock)
    rec.register_source("s", lambda: {})
    rec.record("pass")
    seen = [rec.dump("slo:x", cooldown=60.0) is not None,
            rec.dump("slo:x", cooldown=60.0) is not None,
            rec.dump("slo:y", cooldown=60.0) is not None]
    clock.step(61.0)
    seen.append(rec.dump("slo:x", cooldown=60.0) is not None)
    assert seen == [True, False, True, True]
    return seen, rec.report()


def snapshot_listing_and_drilldown(p: Pkg, tmp):
    rec = p.recorder()
    rec.register_source("s", lambda: {"v": 7})
    rec.record("pass")
    bundle = rec.dump("sigquit", cooldown=0.0)
    snap = rec.snapshot()
    assert snap["bundles"][0]["name"] == bundle["name"] and "_frames" not in json.dumps(snap)
    drill = rec.snapshot(bundle=bundle["name"])
    assert drill["frame_records"][0]["sources"]["s"] == {"v": 7}
    assert rec.snapshot(bundle="flight-9999-nope") is None
    return snap, drill


def dump_lock_timeout_bails(p: Pkg, tmp):
    rec = p.recorder()
    rec.register_source("s", lambda: {})
    rec.record("pass")
    held, release = threading.Event(), threading.Event()

    def holder():
        with rec._lock:
            held.set()
            release.wait(timeout=10)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    held.wait(timeout=10)
    try:
        assert rec.dump("sigquit", lock_timeout=0.05) is None
    finally:
        release.set()
        t.join(timeout=10)
    bundle = rec.dump("sigquit", cooldown=0.0, lock_timeout=0.05)
    assert bundle is not None
    return bundle["name"], bundle["sha256"]


def report_is_deterministic_and_path_free(p: Pkg, tmp):
    def replay(d):
        clock = p.FakeClock()
        rec = p.recorder(clock=clock, flight_dir=d)
        rec.register_source("s", lambda: {"v": 1})
        for _ in range(3):
            rec.record("pass")
            clock.step(1.0)
        rec.dump("slo:x")
        return rec.report()

    a, b = replay(str(tmp / "a")), replay(str(tmp / "b"))
    assert a == b and a["ring_digest"].startswith("sha256:") and "path" not in a["bundles"][0]
    return a


def flight_families_round_trip(p: Pkg, tmp):
    rec = p.recorder()
    rec.register_source("s", lambda: {})
    rec.record("expo-pass")
    rec.dump("expo-trigger", cooldown=0.0)
    fam = parse_exposition(p.metrics.expose())
    assert fam["karpenter_flight_frames_total"]["samples"][
        ("karpenter_flight_frames_total", (("trigger", "expo-pass"),))] >= 1.0
    assert fam["karpenter_flight_dumps_total"]["samples"][
        ("karpenter_flight_dumps_total", (("trigger", "expo-trigger"),))] >= 1.0
    hist = fam["karpenter_flight_bundle_bytes"]
    count = hist["samples"][("karpenter_flight_bundle_bytes_count", ())]
    assert hist["samples"][("karpenter_flight_bundle_bytes_bucket", (("le", "+Inf"),))] == count >= 1.0
    return {name: fam[name]["type"] for name in (
        "karpenter_flight_frames_total", "karpenter_flight_dumps_total",
        "karpenter_flight_ring_depth", "karpenter_flight_bundle_bytes")}


def kernel_registry_as_a_source(p: Pkg, tmp):
    """A frame of the package's kernel registry — its deterministic
    counts, as the reference operator's kernels source reads them
    (counts_snapshot) — and the registry's digested report: the same in
    both packages for the same records."""
    reg = _m(p.name, "observability.kernels").registry()
    reg.reset()
    try:
        reg.record_host("spec.flight", "4x4")
        with reg.batch_scope("flight"):
            reg.record_host("spec.flight", "4x4")
        rec = p.recorder()
        rec.register_source("kernels", reg.counts_snapshot)
        frame = rec.record("pass")
        bundle = rec.dump("slo:kernels", cooldown=0.0)
        assert frame["sources"]["kernels"]["spec.flight"]["shapes"]["4x4"]["host"] == 2
        return p.flight.scrub(frame), bundle["sha256"], reg.report({})
    finally:
        reg.reset()


SCENARIOS = {
    f.__name__: f for f in (
        scrub_volatile, record_sources_and_ring, reset_keeps_sources_and_config,
        bundle_file_format_and_digest, cooldown_dedupes_per_trigger,
        snapshot_listing_and_drilldown, dump_lock_timeout_bails,
        report_is_deterministic_and_path_free, flight_families_round_trip,
        kernel_registry_as_a_source,
    )
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_flight_scenario_matches_the_reference(tmp_path, name):
    seen = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg
        d.mkdir()
        seen[pkg] = SCENARIOS[name](Pkg(pkg), d)
    assert seen[PORT] == seen[JAX]
