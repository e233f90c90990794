"""The Provisioner in the port against the JAX package's.

Every case of tests/test_provisioner.py runs on both packages with its own
assertions (tests/torch_twins.py): the port's harness passes
`engine_factory=default_engine_factory(device="cpu")`, and the NodeClaim
objects in each harness's store, the pod nominations and the events must
equal the reference's. Beside them: the system's entry point as a whole —
pending pods in the store, through the batcher, the solverd client and the
service, to NodeClaims in the store — on a numpy-seeded workload; the
operator's transport selector `build_solver`; and the port's engine
factory's device rule.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402
from torch_topo_cases import api  # noqa: E402

J, T = tw.J, tw.T

torch.set_num_threads(1)


@pytest.mark.parametrize("case", tw.cases("test_provisioner"))
def test_provisioner_case_on_both_packages(case):
    tw.twin("test_provisioner", case)


# -- the entry point as a whole ------------------------------------------------------


def _harness(pkg, options=None):
    if pkg == T:
        return tw.port_provisioner_harness(options)
    return tw.module("helpers", J).make_provisioner_harness(options)


def reconcile_workload(pkg: str, seed: int, n_pods: int = 300):
    """Pending pods drawn by numpy (requests, zone / arch / capacity-type
    selectors) and a daemonset, reconciled once after prewarm."""
    a = api(pkg)
    harness = _harness(pkg)
    clock, store, provider, cluster, informer, prov = harness
    store.create(a.nodepool("default"))
    store.create(a.daemonset("ds", requests={"cpu": "100m"}))
    rng = np.random.RandomState(seed)
    cpus = ["100m", "250m", "500m", "1", "2", "4"]
    mems = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi", "8Gi"]
    wk = a.wk
    selectors = [
        {}, {}, {wk.LABEL_TOPOLOGY_ZONE: "kwok-zone-3"}, {wk.LABEL_ARCH: "arm64"},
        {wk.CAPACITY_TYPE_LABEL_KEY: "spot"},
    ]
    pods = []
    for i in range(n_pods):
        pod = a.unschedulable_pod(
            name=f"pod-{i:04d}",
            requests={"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]},
            node_selector=dict(selectors[rng.randint(len(selectors))]),
        )
        pods.append(store.create(pod))
    informer.flush()
    prov.prewarm()
    for p in pods:
        prov.trigger(p.metadata.uid)
    clock.step(1.5)
    results = prov.reconcile()
    return harness, results


@pytest.mark.parametrize("seed", [0, 1])
def test_reconcile_decides_as_the_reference(seed):
    tffd = api(T).ffd
    with tw.leg(J):
        ref_harness, ref = reconcile_workload(J, seed)
        want = (tw.decisions(ref), tw.store_snapshot(ref_harness))
    solves, fallbacks = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
    with tw.leg(T):
        harness, got = reconcile_workload(T, seed)
        have = (tw.decisions(got), tw.store_snapshot(harness))
    assert want[0][0] and want[1]["nodeclaims"]
    assert len(want[1]["nodeclaims"]) == len(ref.new_node_claims)
    assert have == want
    # the port's solve ran on its engine, through the service
    assert tffd.DEVICE_SOLVES == solves + 1 and tffd.DEVICE_FALLBACKS == fallbacks
    clock, store, provider, cluster, informer, prov = harness
    stats = prov.solver.stats()
    assert stats["requests"] == stats["executed"] == stats["batches"] == 1
    engine = prov.engine_factory(prov._gather_instance_types([store.get("NodePool", "default")]))
    assert engine.device == torch.device("cpu")


# -- build_solver ----------------------------------------------------------------------

BUILD_OPTIONS = {
    "defaults": {},
    "inprocess tuned": {"solverd_queue_depth": 7, "solverd_coalesce_window": 0.25,
                        "solverd_tenant_quota": 4, "solverd_tenant_weights": "gold=2,free=1",
                        "cluster_name": "solo"},
    "socket": {"solver_transport": "socket", "solver_daemon_address": "127.0.0.1:19999",
               "cluster_name": "prod-a"},
    "unix socket": {"solver_transport": "socket", "solver_daemon_address": "/tmp/solverd.sock"},
    "fleet": {"solver_transport": "socket", "cluster_name": "prod-a",
              "solver_daemon_address": "127.0.0.1:9901,127.0.0.1:9902",
              "solverd_replica_breaker_threshold": 5, "solverd_replica_breaker_cooldown": 2.5},
}


def _client_settings(client) -> dict:
    out = {"type": type(client).__name__, "transport": client.transport, "tenant": client.tenant}
    if hasattr(client, "service"):
        q = client.service.queue
        out.update(depth=q.max_depth, quota=q.tenant_quota, weights=q.tenant_weights,
                   window=client.service.coalesce_window)
    if hasattr(client, "address"):
        out.update(address=client.address, attempts=client.reconnect_attempts)
    if hasattr(client, "_replicas"):
        out.update(replicas=[
            (r.replica_id, type(r.client).__name__, r.breaker.threshold, r.breaker.cooldown)
            for r in client._replicas
        ])
    return out


@pytest.mark.parametrize("name", list(BUILD_OPTIONS))
def test_build_solver_gives_the_same_client(name):
    got = {}
    for pkg in (J, T):
        m = api(pkg).m
        options = m("operator.options").Options(**BUILD_OPTIONS[name])
        client = m("solverd").build_solver(options, m("utils.clock").FakeClock())
        got[pkg] = _client_settings(client)
        client.close()
    assert got[T] == got[J]


# -- the engine factory's device ------------------------------------------------------


def test_default_factory_builds_on_the_card_or_raises():
    """`device=None` is the card: without one, building the engine raises
    (as resolve_device does) and the reconcile fails — no CPU engine, no
    host-loop answer."""
    from karpenter_tpu_torch.controllers.provisioning import provisioner

    if torch.cuda.is_available():
        pytest.skip("the card is here")
    factory = provisioner.default_engine_factory()
    catalog = list(api(T).CATALOG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        factory({"default": catalog})
    a = api(T)
    clock, store, provider, cluster, informer, prov = _harness_default_options()
    store.create(a.nodepool("default"))
    pod = store.create(a.unschedulable_pod(requests={"cpu": "1"}))
    prov.trigger(pod.metadata.uid)
    informer.flush()
    clock.step(1.5)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prov.reconcile()
    assert store.list("NodeClaim") == []


def _harness_default_options():
    """tests/helpers.make_provisioner_harness's wiring in the port with the
    Provisioner left to pick its engine factory, as the operator does."""
    m = api(T).m
    clock = m("utils.clock").FakeClock()
    store = m("runtime.store").Store(clock=clock)
    provider = m("cloudprovider.fake").FakeCloudProvider()
    cluster = m("state.cluster").Cluster(clock, store, provider)
    informer = m("state.informer").StateInformer(store, cluster)
    prov = m("controllers.provisioning").Provisioner(
        store, provider, cluster, m("events.recorder").Recorder(clock=clock), clock,
        m("operator.options").Options(),
    )
    return clock, store, provider, cluster, informer, prov


def test_engine_cache_is_keyed_by_device(monkeypatch):
    """A CPU engine and an engine for another device never share an entry
    of the content cache; two factories on one device do."""
    from karpenter_tpu_torch.controllers.provisioning import provisioner
    from karpenter_tpu_torch.ops import catalog as tcatalog

    monkeypatch.setattr(provisioner, "_ENGINE_CONTENT_CACHE", {})
    built = []

    class Recording(tcatalog.CatalogEngine):
        def __init__(self, types, device=None, mesh=None):
            built.append(device)
            super().__init__(types, device="cpu", mesh=mesh)

    monkeypatch.setattr(tcatalog, "CatalogEngine", Recording)
    catalog = {"default": list(api(T).CATALOG)}
    a = provisioner.default_engine_factory(device="cpu")(catalog)
    b = provisioner.default_engine_factory(device="cpu")(catalog)
    c = provisioner.default_engine_factory(device="cuda")(catalog)
    assert a is b and c is not a
    assert built == ["cpu", "cuda"]
    assert sorted(k[1] for k in provisioner._ENGINE_CONTENT_CACHE) == ["cpu", "cuda"]


def test_mesh_builder_is_the_ports():
    from karpenter_tpu_torch import mesh
    from karpenter_tpu_torch.controllers.provisioning import provisioner

    assert provisioner._build_solver_mesh is mesh.build_solver_mesh
    assert provisioner._build_solver_mesh(0) is None
    if torch.cuda.device_count() < 1:
        assert provisioner._build_solver_mesh(1) is None  # warns, stays unsharded
