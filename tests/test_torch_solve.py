"""The port's provisioning solve against the JAX package's.

One numpy-seeded spec — node pools, ~20 pod shapes, a few hundred pods — is
built in each package's own API and solved by each package's
Scheduler.solve with its own CatalogEngine: the JAX engine runs its device
programs (FORCE_BACKEND="device", jitted on the CPU, fused scan off, the
`--fused-solve off` configuration), the port's runs device="cpu" (its plain
torch versions). Decisions must be identical: the claims, their pods, their
instance-type options and requirements, and every pod error string.
"""

from __future__ import annotations

import importlib
import itertools

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import catalog as jcatalog
from karpenter_tpu.ops import ffd as jffd
from karpenter_tpu.ops import fused as jfused
from karpenter_tpu.scheduler import nodeclaim as jnodeclaim
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.ops import ffd as tffd
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim

torch.set_num_threads(1)

SEEDS = range(6)
ZONES = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]


def spec(seed: int) -> dict:
    """The package-neutral workload: plain python values only."""
    rng = np.random.RandomState(seed)
    cpus = ["100m", "250m", "500m", "1", "2", "4", "7"]
    mems = ["128Mi", "512Mi", "1Gi", "4Gi", "12Gi"]
    shapes = []
    for s in range(20):
        sel, affinity = {}, []
        roll = rng.rand()
        if roll < 0.3:
            sel["kubernetes.io/arch"] = ["amd64", "arm64"][rng.randint(2)]
        if roll < 0.15:
            sel["topology.kubernetes.io/zone"] = ZONES[rng.randint(4)]
        if roll > 0.8:
            sel["karpenter.sh/capacity-type"] = "spot"
        if rng.rand() < 0.2:
            affinity.append(
                {"key": "topology.kubernetes.io/zone", "operator": "NotIn",
                 "values": [ZONES[rng.randint(4)]]}
            )
        if rng.rand() < 0.1:
            affinity.append({"key": "kubernetes.io/os", "operator": "In", "values": ["linux"]})
        cpu = cpus[rng.randint(len(cpus))]
        if s == 0 and seed % 2 == 0:
            cpu = "1000"  # fits nothing: a pod error on every pass
        if s == 1 and seed % 3 == 0:
            sel = {"topology.kubernetes.io/zone": "kwok-zone-9"}  # no such zone
        shapes.append((sel, affinity, {"cpu": cpu, "memory": mems[rng.randint(len(mems))]}))
    n = int(rng.randint(300, 1000))
    pools = [{"name": "default", "weight": 10, "requirements": [], "limits": None}]
    if seed % 2:
        pools.append(
            {"name": "zonal", "weight": 50,
             "requirements": [{"key": "topology.kubernetes.io/zone", "operator": "In",
                               "values": ZONES[:2]}],
             "limits": {"cpu": str(int(rng.randint(20, 80)))}}
        )
    return {"shapes": shapes, "picks": rng.randint(len(shapes), size=n).tolist(),
            "pools": pools}


def cluster_spec(seed: int) -> dict:
    """spec(seed) plus a fleet of existing nodes with seeded usage: each
    node carries a single value for every key a pod shape selects on, so the
    fused scan's static node compatibility applies."""
    s = spec(seed)
    rng = np.random.RandomState(1000 + seed)
    nodes = []
    for i in range(int(rng.randint(6, 20))):
        cpu, mem = [("16", "64Gi"), ("32", "128Gi"), ("8", "32Gi")][rng.randint(3)]
        used = [["500m", "1", "2", "4"][rng.randint(4)] for _ in range(rng.randint(0, 4))]
        nodes.append({
            "name": f"existing-{i}", "pool": s["pools"][rng.randint(len(s["pools"]))]["name"],
            "zone": ZONES[rng.randint(4)], "arch": ["amd64", "arm64"][rng.randint(2)],
            "capacity": {"cpu": cpu, "memory": mem, "pods": "110"}, "used": used,
        })
    s["nodes"] = nodes
    return s


def _existing_nodes(m, core, res, store, cluster, nodes):
    """Register each node dict of cluster_spec (and its bound pods) with the
    store and the cluster state, as the informer would."""
    wk = m("apis.labels")
    for n in nodes:
        cap = res.parse_resource_list(n["capacity"])
        node = core.Node(
            metadata=core.ObjectMeta(name=n["name"], labels={
                wk.NODEPOOL_LABEL_KEY: n["pool"],
                wk.LABEL_INSTANCE_TYPE: "s-4x-amd64-linux",
                wk.LABEL_TOPOLOGY_ZONE: n["zone"],
                wk.LABEL_ARCH: n["arch"],
                wk.LABEL_OS: "linux",
                wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                wk.NODE_REGISTERED_LABEL_KEY: "true",
                wk.NODE_INITIALIZED_LABEL_KEY: "true",
                wk.LABEL_HOSTNAME: n["name"],
            }),
            spec=core.NodeSpec(provider_id=f"kwok://{n['name']}"),
            status=core.NodeStatus(capacity=cap, allocatable=dict(cap)),
        )
        store.create(node)
        cluster.update_node(node)
        for j, cpu in enumerate(n["used"]):
            pod = core.Pod(
                metadata=core.ObjectMeta(name=f"{n['name']}-used-{j}", uid=f"{n['name']}-used-{j}"),
                spec=core.PodSpec(
                    node_name=n["name"],
                    containers=[core.Container(requests=res.parse_resource_list({"cpu": cpu}))],
                ),
            )
            pod.metadata.creation_timestamp = 0.0
            pod.status.conditions.append(core.Condition(type="PodScheduled", status="True"))
            store.create(pod)
            cluster.update_pod(pod)


def build_solve(pkg: str, s: dict, extra=()):
    """The spec's Scheduler and pending pods in `pkg`'s API, with `extra`
    pods appended: (name, node_selector, requests) each."""

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    core = m("apis.core")
    res = m("utils.resources")
    NodePool = m("apis.nodepool").NodePool
    catalog = m("cloudprovider.kwok.instance_types").construct_instance_types()
    pods = []
    picked = [(f"pod-{i:05d}", f"uid-{i:05d}", *s["shapes"][si]) for i, si in enumerate(s["picks"])]
    picked += [(name, f"uid-{name}", sel, [], requests) for name, sel, requests in extra]
    for i, (name, uid, sel, affinity, requests) in enumerate(picked):
        aff = None
        if affinity:
            aff = core.Affinity(
                node_affinity=core.NodeAffinity(
                    required=[core.NodeSelectorTerm(match_expressions=[dict(e) for e in affinity])]
                )
            )
        pod = core.Pod(
            metadata=core.ObjectMeta(name=name, uid=uid),
            spec=core.PodSpec(
                node_selector=dict(sel), affinity=aff,
                containers=[core.Container(requests=res.parse_resource_list(requests))],
            ),
        )
        pod.metadata.creation_timestamp = float(i % 7)
        pod.status.conditions.append(
            core.Condition(type="PodScheduled", status="False", reason="Unschedulable")
        )
        pods.append(pod)
    clock = m("utils.clock").FakeClock()
    store = m("runtime.store").Store(clock=clock)
    cluster = m("state.cluster").Cluster(clock, store, cloud_provider=None)
    pools = []
    for p in s["pools"]:
        pool = NodePool(metadata=core.ObjectMeta(name=p["name"]))
        pool.spec.weight = p["weight"]
        pool.spec.template.spec.requirements = [dict(r) for r in p["requirements"]]
        if p["limits"]:
            pool.spec.limits = res.parse_resource_list(p["limits"])
        pool.set_condition("Ready", "True")
        store.create(pool)
        pools.append(pool)
    _existing_nodes(m, core, res, store, cluster, s.get("nodes", ()))
    state_nodes = cluster.state_nodes()
    its = {p.metadata.name: catalog for p in pools}
    kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    engine = m("ops.catalog").CatalogEngine(catalog, **kw)
    topology = m("scheduler.topology").Topology(store, cluster, state_nodes, pools, its, pods)
    scheduler = m("scheduler.scheduler").Scheduler(
        store, pools, cluster, state_nodes, topology, its, [],
        m("events.recorder").Recorder(clock=clock), clock, engine=engine,
    )
    return scheduler, pods


def decisions(results):
    """The claims (pool, pods, instance-type options, requirements), the
    pod errors and the existing nodes' pods of a solve."""
    claims = [
        (
            nc.nodepool_name,
            [p.metadata.uid for p in nc.pods],
            sorted(it.name for it in nc.instance_type_options),
            sorted(
                (r.key, r.complement, sorted(r.values), r.greater_than, r.less_than, r.min_values)
                for r in nc.requirements
            ),
        )
        for nc in results.new_node_claims
    ]
    errors = sorted((p.metadata.uid, str(e)) for p, e in results.pod_errors.items())
    existing = sorted(
        (en.name(), sorted(p.metadata.uid for p in en.pods))
        for en in results.existing_nodes
        if en.pods
    )
    return claims, errors, existing


def solve(pkg: str, s: dict):
    scheduler, pods = build_solve(pkg, s)
    return decisions(scheduler.solve(pods))


@pytest.fixture
def reference_config(monkeypatch):
    """The JAX package in the slice's configuration (device programs on,
    fused scan off), and fresh hostname counters in both packages."""
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")
    monkeypatch.setattr(jfused, "FUSED_MODE", "off")
    for mod in (jnodeclaim, tnodeclaim):
        monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
    for mod in (jffd, tffd):
        monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_decisions_identical(reference_config, seed):
    s = spec(seed)
    j0, t0 = jffd.DEVICE_SOLVES, tffd.DEVICE_SOLVES
    want = solve("karpenter_tpu", s)
    got = solve("karpenter_tpu_torch", s)
    # both took their device path, so the comparison is the kernels' path
    assert jffd.DEVICE_SOLVES == j0 + 1 and tffd.DEVICE_SOLVES == t0 + 1
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[0], "no claims"
    if seed % 2 == 0:
        assert got[1], "the unfittable shape should leave pod errors"


def topology_solve(pkg: str, before_solve=lambda: None):
    """A zone-spread workload: each package runs its topology driver.
    `before_solve` runs after the scheduler is built (which filters the
    templates through the engine)."""

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    core = m("apis.core")
    res = m("utils.resources")
    catalog = m("cloudprovider.kwok.instance_types").construct_instance_types()
    pods = []
    for i in range(120):
        pod = core.Pod(
            metadata=core.ObjectMeta(name=f"tp-{i:04d}", uid=f"tp-{i:04d}",
                                     labels={"app": f"a{i % 2}"}),
            spec=core.PodSpec(
                containers=[core.Container(requests=res.parse_resource_list({"cpu": "1"}))],
                topology_spread_constraints=[
                    core.TopologySpreadConstraint(
                        max_skew=1, topology_key="topology.kubernetes.io/zone",
                        when_unsatisfiable="DoNotSchedule",
                        label_selector=core.LabelSelector(match_labels={"app": f"a{i % 2}"}),
                    )
                ],
            ),
        )
        pod.metadata.creation_timestamp = 0.0
        pod.status.conditions.append(
            core.Condition(type="PodScheduled", status="False", reason="Unschedulable")
        )
        pods.append(pod)
    clock = m("utils.clock").FakeClock()
    store = m("runtime.store").Store(clock=clock)
    cluster = m("state.cluster").Cluster(clock, store, cloud_provider=None)
    pool = m("apis.nodepool").NodePool(metadata=core.ObjectMeta(name="default"))
    pool.set_condition("Ready", "True")
    store.create(pool)
    its = {"default": catalog}
    kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    engine = m("ops.catalog").CatalogEngine(catalog, **kw)
    topology = m("scheduler.topology").Topology(store, cluster, [], [pool], its, pods)
    scheduler = m("scheduler.scheduler").Scheduler(
        store, [pool], cluster, [], topology, its, [],
        m("events.recorder").Recorder(clock=clock), clock, engine=engine,
    )
    before_solve()
    r = scheduler.solve(pods)
    return (
        sorted(
            (sorted(p.metadata.uid for p in nc.pods),
             sorted(it.name for it in nc.instance_type_options))
            for nc in r.new_node_claims
        ),
        sorted((p.metadata.uid, str(e)) for p, e in r.pod_errors.items()),
    )


def test_topology_solve_runs_topology_driver_identically(reference_config):
    """Both packages run their topology driver on a zone-spread workload:
    the port's solve counts as a device solve, and decisions agree."""
    t0, f0 = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
    want = topology_solve("karpenter_tpu")
    got = topology_solve("karpenter_tpu_torch")
    assert (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS) == (t0 + 1, f0)
    assert got == want and got[0]


# what the card raises besides a failed launch: an allocation that fails,
# and a fault of an earlier launch surfacing at the next synchronizing call
# (a plain RuntimeError in older torch)
DEVICE_FAULTS = {
    "kernel": lambda: KernelError("cube: CUDA launch failed with cudaError 1"),
    "oom": lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    "async": lambda: RuntimeError("CUDA error: an illegal memory access was encountered"),
}


def _break_cube(monkeypatch, fault):
    """The sweep's cube entry (the engine's cube_rows) raises `fault`."""
    from karpenter_tpu_torch.ops import feasibility as tfeas

    def broken(*args):
        raise DEVICE_FAULTS[fault]()

    monkeypatch.setattr(tfeas, "cube_rows", broken)


def test_kernel_fault_fails_the_solve(reference_config, monkeypatch):
    """A kernel that fails on the card, an allocation that fails or an
    asynchronous fault in the sweep must fail the solve, as a KernelError:
    the port never covers a device fault with the host loop."""
    for fault, make in DEVICE_FAULTS.items():
        _break_cube(monkeypatch, fault)
        t0, f0 = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
        with pytest.raises(KernelError) as info:
            solve("karpenter_tpu_torch", spec(1))
        if fault != "kernel":
            assert type(info.value.__cause__) is type(make()), fault
        assert (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS) == (t0, f0), fault


@pytest.mark.parametrize("fault", sorted(DEVICE_FAULTS))
def test_device_fault_fails_the_host_loop(reference_config, monkeypatch, fault):
    """On the host loop (a topology solve with the topology driver gated
    off), a device fault in a claim's instance-type filter fails the solve
    instead of becoming a pod error."""
    from karpenter_tpu_torch.ops import ffd_topo as tffd_topo

    monkeypatch.setattr(tffd_topo, "supported", lambda scheduler: False)
    t0 = tffd.DEVICE_SOLVES
    with pytest.raises(KernelError):
        topology_solve("karpenter_tpu_torch", lambda: _break_cube(monkeypatch, fault))
    assert tffd.DEVICE_SOLVES == t0
