"""The consolidation frontier's parity fuzz, prefix reductions, telemetry and coalescer-priming specs in the port against the JAX package's: every case of
tests/test_frontier.py runs on both packages with its own assertions
(tests/torch_twins.py), a parametrized case once a parameter set. The
port's Provisioner gets `default_engine_factory(device="cpu")`; each run
records every Command the disruption controller parks or starts, every
provisioner harness's and disruption env's NodeClaims and events — and the
two packages' records must be equal."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402


@pytest.mark.parametrize("case", tw.cases("test_frontier"))
def test_frontier_case_on_both_packages(case):
    tw.twin("test_frontier", case)


# -- ops/frontier.py directly ----------------------------------------------------


def _candidates(pkg: str, seed: int, n: int) -> list:
    """`n` stand-in candidates of one package, drawn from numpy's seed:
    instance types with random offerings (zones, capacity types, float64
    prices), nodes labelled with a random offering's zone and capacity
    type — or with one no offering has (on-demand or reserved)."""
    import types

    import numpy as np

    rng = np.random.default_rng(seed)
    wk = tw._m(pkg, "apis.labels")
    ctypes_ = tw._m(pkg, "cloudprovider.types")
    Requirements = tw._m(pkg, "scheduling.requirements").Requirements
    zones = ["z-a", "z-b", "z-c"]
    kinds = [wk.CAPACITY_TYPE_ON_DEMAND, wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_RESERVED]
    catalog = []
    for t in range(6):
        offerings = [
            ctypes_.Offering(
                Requirements.from_labels({
                    wk.CAPACITY_TYPE_LABEL_KEY: kinds[int(rng.integers(3))],
                    wk.LABEL_TOPOLOGY_ZONE: zones[int(rng.integers(3))],
                }),
                float(rng.uniform(0.001, 5.0)),
            )
            for _ in range(int(rng.integers(1, 4)))
        ]
        catalog.append(ctypes_.InstanceType(f"type-{t}", Requirements(), offerings, {}))
    out = []
    for _ in range(n):
        it = catalog[int(rng.integers(len(catalog)))]
        if rng.random() < 0.1:
            labels = {wk.CAPACITY_TYPE_LABEL_KEY: kinds[int(rng.integers(3))],
                      wk.LABEL_TOPOLOGY_ZONE: "z-none"}
        else:
            o = it.offerings[int(rng.integers(len(it.offerings)))]
            labels = {wk.CAPACITY_TYPE_LABEL_KEY: o.capacity_type, wk.LABEL_TOPOLOGY_ZONE: o.zone}
        out.append(types.SimpleNamespace(
            instance_type=it,
            state_node=types.SimpleNamespace(labels=lambda labels=labels: labels),
        ))
    return out


def _frontier_ops(pkg: str, seed: int) -> dict:
    ftr = tw._m(pkg, "ops.frontier")
    n = 40 + seed % 30
    cands = _candidates(pkg, seed, n)
    prices = ftr.PrefixPrices(cands)
    floors = ftr.PrefixTypeFloors(cands)
    names = [f"type-{t}" for t in range(6)] + ["absent"]
    return {
        "cumulative": prices._cumulative.tobytes(),
        "prices": [prices.for_prefix(m) for m in range(0, n + 2)],
        "floors": [
            floors.max_price(m, names[a:b])
            for m in range(0, n + 2) for a in range(7) for b in (a + 1, 7)
        ],
    }


def test_speculative_probes_equal_on_both_packages():
    """Every (lo, hi, depth) of a grid: the same probes in the same order."""
    jftr, tftr = tw._m(tw.J, "ops.frontier"), tw._m(tw.T, "ops.frontier")
    for lo in range(0, 20):
        for hi in range(lo - 2, 70, 3):
            for depth in range(0, 6):
                assert tftr.speculative_probes(lo, hi, depth) == jftr.speculative_probes(lo, hi, depth)


@pytest.mark.parametrize("seed", range(6))
def test_prefix_reductions_equal_on_both_packages(seed):
    """PrefixPrices and PrefixTypeFloors on numpy-seeded candidate sets:
    equal with tolerance 0, the float64 cumulative sum bit for bit."""
    ref, port = _frontier_ops(tw.J, seed), _frontier_ops(tw.T, seed)
    assert port == ref
