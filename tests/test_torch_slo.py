"""The port's SLO burn-rate engine (observability/slo.py, a copy of the
reference's) against the JAX package's, on the CPU.

Each scenario is one of the reference's tests/test_slo.py cases that needs no
operator, written against a package (its `slo` module, its FakeClock, its
metrics registry): it makes the reference's assertions and returns what it
saw — breaches, snapshots, reports and digests, exposition samples. Every
scenario runs on both packages, and what it returns must be equal.
"""

from __future__ import annotations

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_metrics_exposition import parse_exposition  # noqa: E402
from test_torch_delta import JAX, PORT, _m  # noqa: E402


class Pkg:
    """One package's SLO surface."""

    def __init__(self, pkg: str):
        self.slo = _m(pkg, "observability.slo")
        self.FakeClock = _m(pkg, "utils.clock").FakeClock
        self.metrics = _m(pkg, "metrics").global_registry
        self.FAST = self.slo.Window("fast", 60.0, 14.4)
        self.SLOW = self.slo.Window("slow", 300.0, 6.0)

    def engine(self, *specs, clock=None):
        return self.slo.SLOEngine(clock=clock or self.FakeClock(), specs=list(specs))

    def ratio_spec(self, name="avail", objective=0.99, availability=False):
        return self.slo.SLOSpec(name, "test objective", objective=objective,
                                windows=(self.FAST, self.SLOW), availability=availability)


def burn_math(p: Pkg):
    br, bud, cap = p.slo._burn_rate, p.slo._budget_remaining, p.slo.BURN_CAP
    assert br(95, 5, 0.99) == pytest.approx(5.0)
    assert br(1000, 1, 1.0) == cap
    assert bud(99, 1, 0.99) == pytest.approx(0.0) and bud(90, 10, 0.99) < 0.0
    return [br(95, 5, 0.99), br(100, 0, 0.99), br(0, 0, 0.99), br(1000, 1, 1.0), br(0, 0, 1.0),
            bud(100, 0, 0.99), bud(99, 1, 0.99), bud(90, 10, 0.99), bud(10, 0, 1.0),
            bud(10, 1, 1.0), bud(0, 0, 0.99)]


def observe_classifies_by_threshold(p: Pkg):
    spec = p.slo.SLOSpec("lat", "", 0.99, windows=(p.FAST,), threshold_s=10.0)
    eng = p.engine(spec)
    for v in (5.0, 10.0, 10.1):
        eng.observe("lat", v)
    series = eng._series[("lat", "")]
    assert (series.cum_good, series.cum_bad) == (2, 1)
    eng.record("nope", good=1)
    eng.observe("nope", 1.0)
    assert ("nope", "") not in eng._series
    return eng.report()


def per_tenant_attribution(p: Pkg):
    eng = p.engine(p.ratio_spec())
    eng.record("avail", good=3, tenant="gold")
    eng.record("avail", bad=1, tenant="free")
    agg = eng._series[("avail", "")]
    assert (agg.cum_good, agg.cum_bad) == (3, 1)
    section = eng.tenant_section("gold")
    assert section["avail"]["events"] == {"good": 3, "bad": 0}
    assert eng.tenant_section("nobody") == {}
    return section, eng.tenant_section("free")


def series_prunes_to_longest_window(p: Pkg):
    clock = p.FakeClock()
    eng = p.engine(p.ratio_spec(), clock=clock)
    eng.record("avail", good=1)
    clock.step(400.0)
    eng.record("avail", good=1)
    eng.evaluate()
    series = eng._series[("avail", "")]
    assert len(series.events) == 1 and series.cum_good == 2
    return eng.report()


def fast_window_trips_before_slow(p: Pkg):
    clock = p.FakeClock()
    spec = p.slo.SLOSpec("lat", "", 0.99, windows=(p.FAST, p.SLOW), threshold_s=1.0)
    eng = p.engine(spec, clock=clock)
    breaches = []
    eng.subscribe(breaches.append, key="t")
    for _ in range(240):
        eng.observe("lat", 0.1)
        eng.evaluate()
        clock.step(1.0)
    assert breaches == []
    tripped = {}
    for i in range(120):
        eng.observe("lat", 30.0)
        for b in eng.evaluate():
            tripped.setdefault(b.window, i)
        clock.step(1.0)
    assert tripped["fast"] < tripped["slow"]
    return tripped, [b.to_dict() for b in breaches], eng.report()


def breach_edges_and_recovery(p: Pkg):
    clock = p.FakeClock()
    eng = p.engine(p.ratio_spec(), clock=clock)
    breaches = []
    eng.subscribe(breaches.append, key="t")
    eng.record("avail", bad=10)
    eng.evaluate()
    eng.evaluate()
    assert len([b for b in breaches if b.window == "fast"]) == 1
    clock.step(120.0)
    eng.record("avail", good=100)
    eng.evaluate()
    assert ("avail", "", "fast") not in eng._burning
    eng.record("avail", bad=50)
    eng.evaluate()
    assert len([b for b in breaches if b.window == "fast"]) == 2
    return [b.to_dict() for b in breaches], eng.snapshot()


def breach_carries_burn_and_budget(p: Pkg):
    eng = p.engine(p.ratio_spec())
    breaches = []
    eng.subscribe(breaches.append, key="t")
    eng.record("avail", good=50, bad=50)
    eng.evaluate()
    b = breaches[0]
    assert b.burn_rate == pytest.approx(50.0) and b.budget_remaining < 0.0
    assert set(b.to_dict()) == {"objective", "tenant", "window", "burn_rate",
                                "budget_remaining", "t"}
    return [x.to_dict() for x in breaches]


def subscribers_isolated_and_keyed(p: Pkg):
    eng = p.engine(p.ratio_spec())
    seen, first, second = [], [], []
    eng.subscribe(lambda b: 1 / 0, key="a")
    eng.subscribe(seen.append, key="b")
    eng.subscribe(first.append, key="sim")
    eng.subscribe(second.append, key="sim")
    eng.record("avail", bad=5)
    eng.evaluate()  # must not raise
    assert len(seen) >= 1 and first == [] and len(second) == 2
    return [b.to_dict() for b in second]


def zero_tolerance_breaches_on_one_bad(p: Pkg):
    spec = p.slo.SLOSpec("recompiles", "", 1.0, windows=(p.slo.Window("steady", 300.0, 1.0),))
    eng = p.engine(spec)
    breaches = []
    eng.subscribe(breaches.append, key="t")
    eng.record("recompiles", bad=1)
    eng.evaluate()
    assert len(breaches) == 1 and breaches[0].burn_rate == p.slo.BURN_CAP
    return [b.to_dict() for b in breaches]


def hard_breach_and_partial_recovery(p: Pkg):
    clock = p.FakeClock()
    eng = p.engine(p.ratio_spec(availability=True), clock=clock)
    assert eng.hard_breached() == []
    eng.record("avail", bad=100)
    eng.evaluate()
    assert eng.hard_breached() == ["avail"]
    worst = eng.worst_burning()
    assert worst["burn_rate"] == pytest.approx(100.0)
    clock.step(90.0)
    eng.record("avail", good=300)
    eng.evaluate()
    assert ("avail", "", "fast") not in eng._burning and ("avail", "", "slow") in eng._burning
    assert eng.hard_breached() == []
    other = p.engine(p.ratio_spec(availability=False))
    other.record("avail", bad=100)
    other.evaluate()
    assert other.hard_breached() == []
    return worst, eng.snapshot()


def snapshot_table_and_drilldown(p: Pkg):
    eng = p.engine(p.ratio_spec())
    eng.record("avail", good=9, bad=1, tenant="gold")
    eng.evaluate()
    snap = eng.snapshot()
    assert snap["objectives"]["avail"]["events"] == {"good": 9, "bad": 1}
    drill = eng.snapshot(objective="avail")
    assert drill["spec"]["name"] == "avail" and "gold" in drill["tenants"]
    assert eng.snapshot(objective="nope") is None
    empty = p.engine(p.ratio_spec()).snapshot()["objectives"]["avail"]
    assert empty["compliance"] == 1.0 and empty["error_budget_remaining"] == 1.0
    return snap, drill, empty


def report_digest_is_replay_stable(p: Pkg):
    def replay():
        clock = p.FakeClock()
        eng = p.engine(p.ratio_spec(), clock=clock)
        for _ in range(10):
            eng.record("avail", good=3, bad=1, tenant="gold")
            eng.evaluate()
            clock.step(5.0)
        return eng.report()

    a, b = replay(), replay()
    assert a == b and a["objectives"]["avail"]["tenants"]["gold"]["events"] == {"good": 30, "bad": 10}
    return a


def reset_keeps_specs_and_subscribers(p: Pkg):
    eng = p.engine(p.ratio_spec())
    seen = []
    eng.subscribe(seen.append, key="t")
    eng.record("avail", bad=5)
    eng.evaluate()
    eng.reset()
    assert eng._series == {} and eng._burning == {}
    assert [s.name for s in eng.specs()] == ["avail"]
    eng.record("avail", bad=5)
    eng.evaluate()
    assert len(seen) >= 2
    return [b.to_dict() for b in seen]


def spec_loading(p: Pkg, tmp_path):
    s = p.slo
    assert s.load_specs("") == s.default_specs() == s.load_specs("default")
    assert s.load_specs("off") == []
    assert sum(x.availability for x in s.default_specs()) == 1
    specs = [p.ratio_spec("a", availability=True),
             s.SLOSpec("b", "zero", 1.0, windows=(s.Window("w", 10.0, 1.0),), threshold_s=2.0)]
    path = tmp_path / "specs.json"
    path.write_text(json.dumps([s.spec_to_dict(x) for x in specs]))
    assert s.load_specs(str(path)) == specs
    return [s.spec_to_dict(x) for x in s.default_specs()], [s.spec_to_dict(x) for x in specs]


def slo_families_round_trip(p: Pkg):
    """karpenter_slo_* on the package's own global registry."""
    clock = p.FakeClock()
    eng = p.slo.engine().configure(clock=clock, specs=[p.ratio_spec("expo-obj")])
    try:
        eng.record("expo-obj", good=19, bad=1, tenant='ten"ant\\x')
        eng.evaluate()
        eng.record("expo-obj", bad=100)
        eng.evaluate()
        clock.step(120.0)
        eng.record("expo-obj", good=100000)
        eng.evaluate()
        fam = parse_exposition(p.metrics.expose())
        out = {}
        for name in ("karpenter_slo_compliance_ratio", "karpenter_slo_burn_rate",
                     "karpenter_slo_breaches_total", "karpenter_slo_breach_duration_seconds"):
            out[name] = (fam[name]["type"], sorted(
                (k, v) for k, v in fam[name]["samples"].items()
                if ("objective", "expo-obj") in k[1]))
        nasty = tuple(sorted((("objective", "expo-obj"), ("tenant", 'ten"ant\\x'))))
        assert ("karpenter_slo_compliance_ratio", nasty) in fam["karpenter_slo_compliance_ratio"]["samples"]
        return out
    finally:
        p.slo.engine().configure(specs=p.slo.default_specs())
        p.slo.engine().reset()


def journey_feeds_solve_latency(p: Pkg, pkg: str):
    """A pod's journey through the solver daemon's hops (admission wait 2 s,
    batch execution 40 s) classified against the solve-latency objective
    when the pod binds: restored in the port's tracing/journey.py."""
    journey = _m(pkg, "tracing.journey")
    eng = p.slo.engine().configure(clock=p.FakeClock(), specs=p.slo.default_specs())
    eng.reset()
    try:
        rec = journey.JourneyRecorder()
        attrs = {"pod": "default/p-0", "namespace": "default", "nodeclaim": "nc-0"}
        rec.export({"name": "pod.pending", "attrs": attrs, "trace": "t1", "start": 0.0, "end": 1.0})
        rec.export({"name": "solverd.queue", "trace": "t1", "start": 1.0, "end": 3.0})
        rec.export({"name": "solverd.solve", "trace": "t1", "start": 3.0, "end": 43.0})
        rec.export({"name": "pod.schedule", "attrs": attrs, "trace": "t1", "start": 43.0, "end": 43.5})
        rec.export({"name": "pod.bind", "attrs": attrs, "start": 60.0, "end": 61.0})
        assert rec.completed_count == 1
        snap = eng.snapshot(objective="solve-latency")
        assert sum(snap["aggregate"]["events"].values()) == 2, snap
        return snap, eng.report()
    finally:
        eng.reset()


SCENARIOS = {
    f.__name__: f for f in (
        burn_math, observe_classifies_by_threshold, per_tenant_attribution,
        series_prunes_to_longest_window, fast_window_trips_before_slow,
        breach_edges_and_recovery, breach_carries_burn_and_budget,
        subscribers_isolated_and_keyed, zero_tolerance_breaches_on_one_bad,
        hard_breach_and_partial_recovery, snapshot_table_and_drilldown,
        report_digest_is_replay_stable, reset_keeps_specs_and_subscribers,
        slo_families_round_trip,
    )
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_scenario_matches_the_reference(name):
    seen = {pkg: SCENARIOS[name](Pkg(pkg)) for pkg in (JAX, PORT)}
    assert seen[PORT] == seen[JAX]


def test_spec_loading_matches_the_reference(tmp_path):
    seen = {}
    for pkg in (JAX, PORT):
        d = tmp_path / pkg
        d.mkdir()
        seen[pkg] = spec_loading(Pkg(pkg), d)
    assert seen[PORT] == seen[JAX]


def test_report_digests_equal_across_packages():
    """The digested report of one replay is the same bytes in both."""
    a = report_digest_is_replay_stable(Pkg(JAX))
    b = report_digest_is_replay_stable(Pkg(PORT))
    assert a["digest"] == b["digest"] and json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_journey_feeds_the_solve_latency_objective():
    seen = {pkg: journey_feeds_solve_latency(Pkg(pkg), pkg) for pkg in (JAX, PORT)}
    assert seen[PORT] == seen[JAX]
