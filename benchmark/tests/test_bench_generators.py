"""The generators: upstream's generic pod mix, repetition from a seed, a
standing churn backlog."""

from __future__ import annotations

import numpy as np

from benchmark.harness.traffic import PodTraffic, canonical_uid, compared, shape_draws
from benchmark.tests.bench_helpers import BENCH, load
from benchmark.tests.bench_helpers import CONFIG as CONFIG_FILE

CONFIG = load(f"{BENCH}/configs/{CONFIG_FILE}")
BURST = load(f"{BENCH}/traffic/burst50k.json")
CHURN = load(f"{BENCH}/traffic/churn10k.json")


def test_shape_draws_are_upstreams_generic_pods():
    mix = CONFIG["pods"]
    shapes, picks = shape_draws(mix)
    # every combination of a label value, a cpu and a memory, no selector
    assert len(shapes) == 7 * 5 * 6 == len(set(map(repr, shapes)))
    assert ({"my-label": "c"}, "500m", "1024Mi") in shapes
    # each of the three drawn uniformly and independently
    label, cpu, mem = np.unravel_index(picks, (7, 5, 6))
    for axis, k in ((label, 7), (cpu, 5), (mem, 6)):
        counts = np.bincount(axis, minlength=k)
        assert counts.sum() == mix["population"] and counts.min() > 0.95 * mix["population"] / k
    assert abs(np.corrcoef(cpu, mem)[0, 1]) < 0.02
    again_shapes, again = shape_draws(mix)
    assert again_shapes == shapes and np.array_equal(again, picks)


def test_traffic_repeats_from_its_seed():
    a, b = PodTraffic(CONFIG["pods"], CHURN, 98765432101), PodTraffic(CONFIG["pods"], CHURN, 98765432101)
    assert a.backlog() == b.backlog()
    assert [a.arrivals(k) for k in range(20)] == [b.arrivals(k) for k in range(20)]
    c = PodTraffic(CONFIG["pods"], CHURN, 98765432102)
    assert [d.shape for d in a.backlog()] != [d.shape for d in c.backlog()]


def test_every_seed_brings_the_same_burst_in_another_order():
    a, b = PodTraffic(CONFIG["pods"], BURST, 1), PodTraffic(CONFIG["pods"], BURST, 2**40 + 3)
    sa, sb = [d.shape for d in a.arrivals(0)], [d.shape for d in b.arrivals(0)]
    assert sa != sb and sorted(sa) == sorted(sb) and len(sa) == BURST["arrivals"]["pods"]
    # a batch's pods are new each pass, and sort as the first pass's do
    assert [canonical_uid(d.uid) for d in a.arrivals(7)] == [canonical_uid(d.uid) for d in a.arrivals(0)]
    assert {d.uid for d in a.arrivals(7)}.isdisjoint({d.uid for d in a.arrivals(0)})


def test_churn_backlog_stays_at_its_size():
    gen = PodTraffic(CONFIG["pods"], CHURN, 31415926535)
    pending = gen.backlog()
    assert len(pending) == CHURN["backlog"] == 10_000
    for k in range(60):
        arrivals = gen.arrivals(k)
        assert len(arrivals) == CHURN["arrivals"]["pods"] and len({d.shape for d in arrivals}) == 1
        pending.extend(arrivals)
        del pending[:gen.departures(pending)]
        assert len(pending) == 10_000
    assert pending[-1].uid == "a000059-023"  # the newest stay, the oldest left


def test_compared_passes_are_drawn_from_the_seed():
    assert compared(CHURN, 77, 5, 0)  # the first measured pass, whatever its number
    picks = [k for k in range(400) if compared(CHURN, 77, k, 1)]
    assert picks == [k for k in range(400) if compared(CHURN, 77, k, 1)]
    assert picks != [k for k in range(400) if compared(CHURN, 78, k, 1)]
    assert 0 < len(picks) < 400 and not compared(CHURN, 77, picks[0], CHURN["compare"]["max"])
    assert all(compared({"compare": {"one_in": 1, "max": 10**6}}, 77, k, 5) for k in range(5))
