"""The plain references against the program on CPU engines at small
sizes, and the configuration's catalog against the program's own."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark.harness import judge
from benchmark.harness import workload as wl
from benchmark.harness.traffic import PodTraffic
from benchmark.reference import OutOfScope
from benchmark.reference import catalog as refcat
from benchmark.tests.bench_helpers import BENCH, CONFIG, load

CFG = load(f"{BENCH}/configs/{CONFIG}")


def _described(catalog) -> list:
    return [(it.name, {r.key: r.values for r in it.requirements},
             [({r.key: r.any() for r in o.requirements}, o.price, o.available) for o in it.offerings],
             dict(it.capacity), dict(it.overhead.kube_reserved)) for it in catalog]


def test_configured_catalog_is_the_programs_kwok_catalog():
    """The configuration states the port's kwok catalog: the types the
    benchmark builds from its numbers are the provider's, field by field."""
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types

    assert _described(wl.build_catalog(dict(CFG["catalog"], repeat=1))) == _described(construct_instance_types())


def test_reference_catalog_is_the_programs():
    program = wl.build_catalog(CFG["catalog"])
    ref = refcat.kwok_catalog(CFG["catalog"])
    assert [it.name for it in program] == ref.names and len(ref) == 1008
    alloc = np.array([[it.allocatable()[k] for k in ("cpu", "memory", "pods")] for it in program])
    np.testing.assert_array_equal(alloc, ref.allocatable)
    for it, labels, offs in zip(program, ref.labels, ref.offerings):
        assert {r.key: r.values for r in it.requirements} == labels
        assert [({r.key: r.any() for r in o.requirements}, o.price, o.available) for o in it.offerings] == offs


@pytest.mark.parametrize("seed", [5, 2**33 + 11])
def test_provisioning_reference_decides_as_the_program(seed):
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    traffic = {"backlog": 1500, "arrivals": {"pods": 0, "kind": "batch"}, "departures": "all"}
    gen = PodTraffic(CFG["pods"], traffic, seed)
    demands = gen.backlog()
    cfg = dict(CFG, catalog=dict(CFG["catalog"], repeat=1))
    catalog = wl.build_catalog(cfg["catalog"])
    ctx = wl.SolveContext(CFG["nodepools"], catalog, CatalogEngine(catalog, device="cpu"))
    pods = wl.PodFactory(gen.shapes).pods(demands)
    got = wl.decisions(ctx.scheduler(pods).solve(pods))
    want = judge.provisioning_reference(cfg).solve(judge.reference_pods(gen.shapes, demands))
    assert len(got["claims"]) > 5
    assert judge.mismatch(got, want) == 0


def test_provisioning_reference_refuses_what_it_does_not_decide():
    with pytest.raises(OutOfScope):
        judge.provisioning_reference(dict(CFG, nodepools=CFG["nodepools"] * 2))
