"""The solverd fleet in the port against the JAX package's.

Every case of tests/test_fleet.py (failover over per-replica breakers,
affinity routing, request-id dedup, tenant fairness, graceful drain, the
admission pipeline) runs on both packages with its own assertions
(tests/torch_twins.py). Beside them, the routing key: the port's catalog
hash (its `aot.compiler.content_hash`, as the reference's fleet imports it)
must equal the reference's `aot.compiler.content_hash` on the kwok catalog
and on its x7 copy; a fleet of either package must then order its
replicas alike for every key, so each key lands on the same replica.
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402
from torch_topo_cases import api  # noqa: E402

J, T = tw.J, tw.T

torch.set_num_threads(1)


@pytest.mark.parametrize("case", tw.cases("test_fleet"))
def test_fleet_case_on_both_packages(case):
    tw.twin("test_fleet", case)


def catalog_x(pkg: str, repeat: int) -> list:
    """The kwok catalog and `repeat - 1` renamed copies of it (chip_smoke.py's
    1008-type catalog at repeat 7)."""
    types_ = api(pkg).m("cloudprovider.types")
    base = list(api(pkg).CATALOG)
    out = list(base)
    for r in range(1, repeat):
        for it in base:
            out.append(types_.InstanceType(
                name=f"{it.name}-r{r}", requirements=it.requirements, offerings=it.offerings,
                capacity=it.capacity, overhead=it.overhead,
            ))
    return out


def _port_hash(catalog) -> str:
    from karpenter_tpu_torch.solverd.fleet import FleetClient

    return FleetClient._catalog_hash(SimpleNamespace(engine=SimpleNamespace(instance_types=catalog)))


@pytest.mark.parametrize("repeat", [1, 7])
def test_catalog_hash_is_the_references_content_hash(repeat):
    from karpenter_tpu.aot.compiler import content_hash

    want = content_hash(catalog_x(J, repeat))
    assert _port_hash(catalog_x(T, repeat)) == want
    assert len(want) == 64


def test_catalog_hash_of_a_real_engine_is_memoized():
    from karpenter_tpu.aot.compiler import content_hash
    from karpenter_tpu_torch.ops.catalog import CatalogEngine
    from karpenter_tpu_torch.solverd.fleet import FleetClient

    engine = CatalogEngine(api(T).CATALOG, device="cpu")
    scheduler = SimpleNamespace(engine=engine)
    got = FleetClient._catalog_hash(scheduler)
    assert got == content_hash(api(J).CATALOG)
    assert engine._fleet_content_hash == got
    assert FleetClient._catalog_hash(SimpleNamespace(engine=None)) == "no-engine"


def _fleet(pkg, n, tenant):
    sd = api(pkg).m("solverd")

    class Replica(sd.SolverClient):
        transport = "fake"

    replicas = [(f"replica-{i}", Replica()) for i in range(n)]
    return sd.FleetClient(replicas, clock=api(pkg).m("utils.clock").FakeClock(), tenant=tenant)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_rendezvous_order_is_the_references(n):
    """For tenants x catalogs (the kwok catalog and its x2..x7 copies), both
    packages' fleets rank the replicas in the same order."""
    orders = {}
    for pkg in (J, T):
        catalogs = [catalog_x(pkg, repeat) for repeat in range(1, 8)]
        order = []
        for tenant in ("", "prod-a", "prod-b", "staging"):
            fleet = _fleet(pkg, n, tenant)
            for catalog in catalogs:
                engine = SimpleNamespace(instance_types=catalog)
                key = fleet._affinity_key(SimpleNamespace(engine=engine), None)
                order.append((key, [r.replica_id for r in fleet._route(key)]))
        orders[pkg] = order
    assert orders[T] == orders[J]
    # the keys do spread: not every key prefers one replica
    assert len({o[0] for _, o in orders[T]}) > 1
