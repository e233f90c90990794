"""The reference's randomized solve cases, built in either package's API.

A copy of the case generator of tests/test_device_parity.py (the
`_random_*` builders, `reserved_catalog`, `build_case` and `decisions`)
that takes the package name: `build_case("karpenter_tpu", ...)` draws the
same random sequence and builds the same objects as the reference's own
generator, `build_case("karpenter_tpu_torch", ...)` builds them in the
port's classes. The object builders of tests/helpers.py and the test
scheduler environment of tests/test_scheduler.py (`Env`) are copied the
same way; `Env` feeds the cluster state through the package's own
`state/informer.StateInformer`, as the reference's `Env` does.
"""

from __future__ import annotations

import copy
import functools
import importlib
import itertools
import random
from types import SimpleNamespace
from typing import Sequence


@functools.lru_cache(maxsize=None)
def api(pkg: str) -> SimpleNamespace:
    """The names the generator uses, from package `pkg`, and the object
    builders bound to it."""

    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    core = m("apis.core")
    types = m("cloudprovider.types")
    reqs = m("scheduling.requirements")
    a = SimpleNamespace(pkg=pkg, m=m, wk=m("apis.labels"), ffd=m("ops.ffd"))
    for name in (
        "Affinity", "LabelSelector", "NodeAffinity", "NodeSelectorTerm", "PodAffinity",
        "PodAffinityTerm", "PodAntiAffinity", "PreferredSchedulingTerm", "Taint",
        "Toleration", "TopologySpreadConstraint", "WeightedPodAffinityTerm",
        "ContainerPort", "CSINode", "CSINodeDriver", "ObjectMeta",
        "PersistentVolumeClaim", "StorageClass", "Volume",
    ):
        setattr(a, name, getattr(core, name))
    for name in ("RESERVATION_ID_LABEL", "InstanceType", "Offering", "Offerings"):
        setattr(a, name, getattr(types, name))
    for name in ("Operator", "Requirement", "Requirements"):
        setattr(a, name, getattr(reqs, name))
    a.CATALOG = m("cloudprovider.kwok.instance_types").construct_instance_types()
    parse = m("utils.resources").parse_resource_list
    NodePool = m("apis.nodepool").NodePool
    counter = [0]

    def _name(prefix):
        counter[0] += 1
        return f"{prefix}-{counter[0]}"

    def unschedulable_pod(name=None, requests=None, labels=None, node_selector=None,
                          **spec_kwargs):
        pod = core.Pod(
            metadata=core.ObjectMeta(name=name or _name("pod"), labels=labels or {}),
            spec=core.PodSpec(
                node_selector=node_selector or {},
                containers=[core.Container(requests=parse(requests or {"cpu": "100m"}))],
                **spec_kwargs,
            ),
        )
        pod.status.conditions.append(
            core.Condition(type="PodScheduled", status="False", reason="Unschedulable")
        )
        return pod

    def nodepool(name=None, requirements: Sequence[dict] = (), labels=None,
                 taints: Sequence = (), limits=None, weight: int = 0):
        np_ = NodePool(metadata=core.ObjectMeta(name=name or _name("nodepool")))
        np_.spec.template.spec.requirements = list(requirements)
        np_.spec.template.labels = dict(labels or {})
        np_.spec.template.spec.taints = list(taints)
        np_.spec.weight = weight
        if limits:
            np_.spec.limits = parse(limits)
        np_.set_condition("Ready", "True")
        return np_

    def daemonset(name=None, requests=None):
        ds = core.DaemonSet(metadata=core.ObjectMeta(name=name or _name("daemonset")))
        ds.spec.template_spec.containers = [
            core.Container(requests=parse(requests or {"cpu": "100m"}))
        ]
        return ds

    def daemonset_pod(ds, node_name: str = ""):
        return core.Pod(
            metadata=core.ObjectMeta(
                name=_name(f"{ds.metadata.name}-pod"),
                namespace=ds.metadata.namespace,
                owner_references=[
                    core.OwnerReference(kind="DaemonSet", name=ds.metadata.name,
                                        uid=ds.metadata.uid)
                ],
            ),
            spec=core.PodSpec(
                node_name=node_name,
                containers=[core.Container(requests=dict(c.requests))
                            for c in ds.spec.template_spec.containers],
            ),
        )

    def registered_node(name=None, pool="default", instance_type="t-4-16",
                        zone="kwok-zone-1", capacity=None, allocatable=None,
                        labels=None, taints: Sequence = ()):
        wk = a.wk
        name = name or _name("node")
        node_labels = {
            wk.NODEPOOL_LABEL_KEY: pool,
            wk.LABEL_INSTANCE_TYPE: instance_type,
            wk.LABEL_TOPOLOGY_ZONE: zone,
            wk.NODE_REGISTERED_LABEL_KEY: "true",
            wk.NODE_INITIALIZED_LABEL_KEY: "true",
            wk.LABEL_HOSTNAME: name,
        }
        node_labels.update(labels or {})
        cap = parse(capacity or {"cpu": "4", "memory": "16Gi", "pods": "110"})
        return core.Node(
            metadata=core.ObjectMeta(name=name, labels=node_labels),
            spec=core.NodeSpec(provider_id=f"kwok://{name}", taints=list(taints)),
            status=core.NodeStatus(
                capacity=cap,
                allocatable=parse(allocatable) if allocatable else dict(cap),
            ),
        )

    def bind_pod(pod, node):
        pod.spec.node_name = node.metadata.name
        pod.status.conditions = [c for c in pod.status.conditions if c.type != "PodScheduled"]
        pod.status.conditions.append(core.Condition(type="PodScheduled", status="True"))
        return pod

    a.unschedulable_pod = unschedulable_pod
    a.nodepool = nodepool
    a.daemonset = daemonset
    a.daemonset_pod = daemonset_pod
    a.registered_node = registered_node
    a.bind_pod = bind_pod
    return a


class Env:
    """tests/test_scheduler.py's Env in package `pkg`: a store, a cluster
    state fed by the package's informer, and one solve of Scheduler.solve
    over a fresh Topology."""

    def __init__(self, pkg, node_pools, state_nodes=(), daemonset_pods=(), pods=(),
                 catalog=None, **scheduler_kwargs):
        a = api(pkg)
        m = a.m
        self.m = m
        self.clock = m("utils.clock").FakeClock()
        self.store = m("runtime.store").Store(clock=self.clock)
        self.cluster = m("state.cluster").Cluster(self.clock, self.store, cloud_provider=None)
        self.informer = m("state.informer").StateInformer(self.store, self.cluster)
        self.recorder = m("events.recorder").Recorder(clock=self.clock)
        self.node_pools = sorted(node_pools, key=lambda np_: -(np_.spec.weight or 0))
        for np_ in self.node_pools:
            self.store.create(np_)
        for obj in state_nodes:
            self.store.create(obj)
        for p in pods:
            self.store.create(p)
        self.informer.flush()
        self.instance_types = {
            np_.metadata.name: list(catalog or a.CATALOG) for np_ in self.node_pools
        }
        self.daemonset_pods = list(daemonset_pods)
        self.scheduler_kwargs = scheduler_kwargs

    def schedule(self, pods, timeout=60.0):
        m = self.m
        state_nodes = self.cluster.state_nodes()
        topology = m("scheduler.topology").Topology(
            self.store, self.cluster, state_nodes, self.node_pools,
            self.instance_types, pods,
            preference_policy=self.scheduler_kwargs.get("preference_policy", "Respect"),
        )
        self.scheduler = m("scheduler.scheduler").Scheduler(
            self.store, self.node_pools, self.cluster, state_nodes, topology,
            self.instance_types, self.daemonset_pods, self.recorder, self.clock,
            **self.scheduler_kwargs,
        )
        return self.scheduler.solve(pods, timeout=timeout)


def reset_counters(pkg: str) -> None:
    """Hostname placeholder strings are decision-relevant under topology
    (sorted-domain iteration): every leg draws from a fresh sequence."""
    a = api(pkg)
    a.m("scheduler.nodeclaim")._hostname_counter = itertools.count(1)
    a.ffd._placeholder_counter = itertools.count(1)


def case_catalog(pkg: str, reserved=False, strict=False) -> list:
    """The catalog a case solves against: the kwok catalog, or with
    reserved capacity its copy with reserved offerings."""
    return reserved_catalog(api(pkg)) if reserved or strict else api(pkg).CATALOG


def case_env(pkg: str, case, engine=None, reserved=False, strict=False,
             best_effort=False) -> Env:
    """An Env over a fresh copy of `case` (build_case's tuple) with `engine`."""
    pools, nodes, bound, ds_pods, _ = case
    extra = {"reserved_offering_mode": "Strict"} if strict else {}
    if best_effort:
        extra["min_values_policy"] = "BestEffort"
    return Env(
        pkg,
        node_pools=copy.deepcopy(pools),
        state_nodes=copy.deepcopy(nodes),
        pods=copy.deepcopy(bound),
        daemonset_pods=copy.deepcopy(ds_pods),
        catalog=case_catalog(pkg, reserved, strict),
        engine=engine,
        **extra,
    )


_CATALOG_RES: dict = {}


def reserved_catalog(a):
    """The kwok catalog with deterministic reserved offerings grafted onto
    every 9th type (two zones, ~quarter price, small per-reservation
    capacities) — exercises the fallback-mode reservation bookkeeping:
    capacity counting across claims, release on narrowing, finalize pinning."""
    if a.pkg in _CATALOG_RES:
        return _CATALOG_RES[a.pkg]

    out = []
    for i, it in enumerate(a.CATALOG):
        if i % 9 != 0:
            out.append(it)
            continue
        od = min(o.price for o in it.offerings)
        res_offs = [
            a.Offering(
                requirements=a.Requirements(
                    a.Requirement(
                        a.wk.CAPACITY_TYPE_LABEL_KEY,
                        a.Operator.IN,
                        [a.wk.CAPACITY_TYPE_RESERVED],
                    ),
                    a.Requirement(a.wk.LABEL_TOPOLOGY_ZONE, a.Operator.IN, [zone]),
                    a.Requirement(
                        a.RESERVATION_ID_LABEL, a.Operator.IN, [f"cr-{i}-{zone}"]
                    ),
                ),
                price=od * 0.25,
                available=True,
                reservation_capacity=1 + (i // 9) % 3,
            )
            for zone in ("kwok-zone-1", "kwok-zone-2")
        ]
        out.append(
            a.InstanceType(
                name=it.name,
                requirements=it.requirements,
                offerings=a.Offerings(list(it.offerings) + res_offs),
                capacity=it.capacity,
                overhead=it.overhead,
            )
        )
    _CATALOG_RES[a.pkg] = out
    return out


ZONES = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
ARCHS = ["amd64", "arm64"]
OSES = ["linux", "windows"]
CPUS = ["250m", "500m", "1", "2", "3", "4", "7", "16"]
MEMS = ["256Mi", "512Mi", "1Gi", "2Gi", "7Gi"]


APPS = ["app-0", "app-1", "app-2"]
TIERS = ["gold", "silver", "bronze"]


def _random_nodepools(
    a, rng: random.Random, topo: bool = False, best_effort: bool = False,
    fused: bool = False,
):
    pools = []
    for i in range(rng.randint(1, 3)):
        requirements = []
        if rng.random() < 0.4:
            requirements.append(
                {"key": a.wk.LABEL_ARCH, "operator": "In", "values": [rng.choice(ARCHS)]}
            )
        if topo and rng.random() < 0.3:
            # custom-key domain universe for "tier"-keyed spread
            # (topology.go buildDomainGroups from a.nodepool requirements)
            requirements.append(
                {
                    "key": "tier",
                    "operator": "In",
                    "values": rng.sample(TIERS, rng.randint(1, 3)),
                }
            )
        if rng.random() < 0.3:
            requirements.append(
                {
                    "key": a.wk.LABEL_TOPOLOGY_ZONE,
                    "operator": rng.choice(["In", "NotIn"]),
                    "values": rng.sample(ZONES, rng.randint(1, 2)),
                }
            )
        if rng.random() < (0.0 if fused else 0.85 if best_effort else 0.25):
            # strict-policy minValues (device-supported since round 4):
            # diversity gates reject joins as claims narrow. BestEffort mode
            # amps both frequency and magnitude so many opens actually
            # relax (counts above the catalog's diversity force write-downs)
            requirements.append(
                {
                    "key": rng.choice(
                        [a.wk.LABEL_INSTANCE_TYPE, "karpenter.kwok.sh/instance-family"]
                    ),
                    "operator": "Exists",
                    "minValues": rng.choice(
                        [2, 3, 5, 12, 20, 150, 500]
                        if best_effort
                        else [2, 3, 5, 12]
                    ),
                }
            )
        taints = []
        if rng.random() < 0.25:
            taints.append(a.Taint(key="team", value="infra", effect="NoSchedule"))
        if rng.random() < 0.12 and not fused:
            # engages the relax ladder's wildcard-toleration rung for the
            # whole solve (routes to the topo driver; the fused generator
            # skips it — the one-dispatch scan declines topo-routed solves)
            taints.append(a.Taint(key="soft", value="lane", effect="PreferNoSchedule"))
        limits = None
        if rng.random() < 0.3:
            limits = {"cpu": str(rng.choice([16, 64, 256]))}
        pools.append(
            a.nodepool(
                f"pool-{i}",
                requirements=requirements,
                taints=taints,
                limits=limits,
                weight=rng.randint(0, 10),
            )
        )
    return pools


def _random_selector(a, rng: random.Random):
    roll = rng.random()
    if roll < 0.15:
        return None  # nil selector: matches nothing, but lists every pod in
        # _count_domains (topology.go:466-471 TopologyListOptions mirror)
    if roll < 0.75:
        return a.LabelSelector(match_labels={"app": rng.choice(APPS)})
    return a.LabelSelector(
        match_expressions=[
            {
                "key": "app",
                "operator": "In",
                "values": rng.sample(APPS, rng.randint(1, 2)),
            }
        ]
    )


def _random_spread(a, rng: random.Random):
    roll = rng.random()
    if roll < 0.55:
        key = a.wk.LABEL_TOPOLOGY_ZONE
    elif roll < 0.7:
        key = a.wk.LABEL_HOSTNAME
    elif roll < 0.8:
        key = a.wk.CAPACITY_TYPE_LABEL_KEY
    elif roll < 0.9:
        key = a.wk.LABEL_ARCH
    else:
        key = "tier"
    tsc = a.TopologySpreadConstraint(
        max_skew=rng.choice([1, 1, 1, 2, 3]),
        topology_key=key,
        when_unsatisfiable=rng.choice(
            ["DoNotSchedule", "DoNotSchedule", "ScheduleAnyway"]
        ),
        label_selector=_random_selector(a, rng),
    )
    if rng.random() < 0.2:
        tsc.min_domains = rng.randint(1, 4)
    if rng.random() < 0.25:
        tsc.node_affinity_policy = rng.choice(["Honor", "Ignore"])
    if rng.random() < 0.2:
        tsc.node_taints_policy = rng.choice(["Honor", "Ignore"])
    if rng.random() < 0.15:
        tsc.match_label_keys = ["app"]
    return tsc


def _random_aff_term(a, rng: random.Random, own_app: str):
    key = rng.choice(
        [a.wk.LABEL_TOPOLOGY_ZONE, a.wk.LABEL_TOPOLOGY_ZONE, a.wk.LABEL_HOSTNAME]
    )
    # sometimes target the pod's own app (self-affinity / one-per-domain
    # anti-affinity), sometimes another app in the batch
    target = own_app if rng.random() < 0.6 else rng.choice(APPS)
    return a.PodAffinityTerm(
        topology_key=key,
        label_selector=a.LabelSelector(match_labels={"app": target}),
    )


def _random_pod_affinity(a, rng: random.Random, own_app: str):
    aff = a.Affinity()
    roll = rng.random()
    if roll < 0.45:
        terms = [_random_aff_term(a, rng, own_app)]
        if rng.random() < 0.3:
            aff.pod_affinity = a.PodAffinity(preferred=[
                a.WeightedPodAffinityTerm(weight=rng.randint(1, 100), pod_affinity_term=t)
                for t in terms
            ])
        else:
            aff.pod_affinity = a.PodAffinity(required=terms)
    else:
        terms = [_random_aff_term(a, rng, own_app)]
        if rng.random() < 0.3:
            aff.pod_anti_affinity = a.PodAntiAffinity(preferred=[
                a.WeightedPodAffinityTerm(weight=rng.randint(1, 100), pod_affinity_term=t)
                for t in terms
            ])
        else:
            aff.pod_anti_affinity = a.PodAntiAffinity(required=terms)
    return aff


def _random_node_affinity(a, rng: random.Random):
    """Preferred and/or multi-term required node affinity (relax-ladder
    coverage: preferences.go:70-83, 55-61)."""
    na = a.NodeAffinity()
    if rng.random() < 0.6:
        na.preferred = [
            a.PreferredSchedulingTerm(
                weight=rng.randint(1, 100),
                preference=a.NodeSelectorTerm(
                    match_expressions=[
                        {
                            "key": a.wk.LABEL_TOPOLOGY_ZONE,
                            "operator": "In",
                            "values": rng.sample(ZONES, rng.randint(1, 2)),
                        }
                    ]
                ),
            )
            for _ in range(rng.randint(1, 2))
        ]
    if rng.random() < 0.4 or not na.preferred:
        na.required = [
            a.NodeSelectorTerm(
                match_expressions=[
                    {
                        "key": a.wk.LABEL_TOPOLOGY_ZONE,
                        "operator": "In",
                        "values": rng.sample(ZONES, rng.randint(1, 3)),
                    }
                ]
            )
            for _ in range(rng.randint(1, 2))
        ]
    return a.Affinity(node_affinity=na)


def _random_shape(
    a, rng: random.Random, si: int, topo: bool = False, fused: bool = False
):
    kwargs = {"requests": {"cpu": rng.choice(CPUS), "memory": rng.choice(MEMS)}}
    if topo:
        own_app = rng.choice(APPS)
        if rng.random() < 0.8:
            kwargs["labels"] = {"app": own_app}
        n_tsc = rng.choice([0, 1, 1, 1, 2]) if rng.random() < 0.45 else 0
        if n_tsc:
            kwargs["topology_spread_constraints"] = [
                _random_spread(a, rng) for _ in range(n_tsc)
            ]
        aff_roll = rng.random()
        if aff_roll < 0.18:
            kwargs["affinity"] = _random_pod_affinity(a, rng, own_app)
        elif aff_roll < 0.3:
            kwargs["affinity"] = _random_node_affinity(a, rng)
        if rng.random() < 0.12:
            # host ports: same-port shapes conflict (wildcard IP), distinct
            # IPs coexist — claims accumulate usage on the topo driver
            kwargs["host_port"] = a.ContainerPort(
                container_port=80,
                host_port=rng.choice([8080, 8080, 9090, 7070]),
                host_ip=rng.choice(["", "", "10.0.0.1"]),
                protocol=rng.choice(["TCP", "TCP", "UDP"]),
            )
        if rng.random() < 0.1:
            # PVC-backed volumes: per-pod or shared claims against CSI
            # attach limits on seeded existing nodes
            kwargs["volume"] = rng.choice(["own", "own", f"shared-{si}"])
    selector = {}
    roll = rng.random()
    if roll < 0.3:
        selector[a.wk.LABEL_ARCH] = rng.choice(ARCHS)
    if 0.2 < roll < 0.45:
        selector[a.wk.LABEL_TOPOLOGY_ZONE] = rng.choice(ZONES)
    if roll > 0.9:
        selector[a.wk.LABEL_OS] = rng.choice(OSES)
    if roll > 0.97 and not fused:
        # seeded nodes carry no capacity-type label: a ct-selecting group
        # would make the node requirement state narrowable, which the fused
        # scan's static node tables decline — keep the fused generator
        # inside the scan-shaped class so its fallback assert stays at zero
        selector[a.wk.CAPACITY_TYPE_LABEL_KEY] = rng.choice(
            [a.wk.CAPACITY_TYPE_SPOT, a.wk.CAPACITY_TYPE_ON_DEMAND]
        )
    hostname_pin = None
    if rng.random() < 0.06 and not fused:
        # hostname pins: an existing node's name (joins it if feasible), a
        # bogus name (per-template compat errors embedding the consumed
        # placeholder strings), or a NotIn row (satisfied by any placeholder)
        hn_roll = rng.random()
        if hn_roll < 0.45:
            selector[a.wk.LABEL_HOSTNAME] = f"existing-{rng.randint(0, 5)}"
        elif hn_roll < 0.8:
            selector[a.wk.LABEL_HOSTNAME] = "no-such-node"
        else:
            hostname_pin = f"existing-{rng.randint(0, 5)}"
    if selector:
        kwargs["node_selector"] = selector
    spec_kwargs = {}
    if hostname_pin is not None and "affinity" not in kwargs:
        spec_kwargs["affinity"] = a.Affinity(
            node_affinity=a.NodeAffinity(
                required=[
                    a.NodeSelectorTerm(
                        match_expressions=[
                            {
                                "key": a.wk.LABEL_HOSTNAME,
                                "operator": "NotIn",
                                "values": [hostname_pin],
                            }
                        ]
                    )
                ]
            )
        )
    if rng.random() < 0.25:
        spec_kwargs["tolerations"] = [
            a.Toleration(key="team", operator="Equal", value="infra", effect="NoSchedule")
        ]
    if rng.random() < 0.15 and "affinity" not in kwargs and "affinity" not in spec_kwargs:
        op = rng.choice(["In", "NotIn"])
        spec_kwargs["affinity"] = a.Affinity(
            node_affinity=a.NodeAffinity(
                required=[
                    a.NodeSelectorTerm(
                        match_expressions=[
                            {
                                "key": a.wk.LABEL_TOPOLOGY_ZONE,
                                "operator": op,
                                "values": rng.sample(ZONES, rng.randint(1, 3)),
                            }
                        ]
                    )
                ]
            )
        )
    if rng.random() < 0.04:
        kwargs["requests"] = {"cpu": "10000"}  # unschedulable: error-path parity
    return kwargs, spec_kwargs


def build_case(
    pkg: str,
    seed: int,
    topo: bool = False,
    reserved: bool = False,
    cluster: bool = False,
    best_effort: bool = False,
    fused: bool = False,
):
    """(node_pools, state_nodes, bound_pods, daemonset_pods, build_pods),
    built in package `pkg`'s own API."""
    a = api(pkg)
    rng = random.Random(
        seed + 1_000_000
        if topo and not best_effort
        else seed + 2_000_000
        if reserved
        else seed + 3_000_000
        if cluster and not fused
        else seed + 4_000_000
        if best_effort and not topo
        else seed + 5_000_000
        if best_effort
        else seed + 6_000_000
        if fused and not cluster
        else seed + 7_000_000
        if fused
        else seed
    )
    pools = _random_nodepools(a, rng, topo, best_effort, fused)
    nodes = []
    bound = []
    # cluster mode: a steady-state fleet — most pods join EXISTING nodes,
    # exercising the _try_nodes path, per-node usage tracking, and the
    # emptiest-first/in-order scan at production-like node counts
    n_existing = rng.randint(24, 64) if cluster else rng.randint(0, 6)
    for i in range(n_existing):
        pool = rng.choice(pools).metadata.name
        labels = {a.wk.LABEL_ARCH: "amd64", a.wk.LABEL_OS: "linux"}
        if topo and rng.random() < 0.3:
            labels["tier"] = rng.choice(TIERS)
        if cluster:
            size = rng.choice([("16", "64Gi"), ("16", "64Gi"), ("32", "128Gi"), ("8", "32Gi")])
        else:
            size = ("16", "64Gi")
        node = a.registered_node(
            name=f"existing-{i}",
            pool=pool,
            instance_type="s-4x-amd64-linux",
            zone=rng.choice(ZONES),
            capacity={"cpu": size[0], "memory": size[1], "pods": "110"},
            labels=labels,
        )
        nodes.append(node)
        if cluster and rng.random() < 0.7:
            # seed partial usage so nodes present varied headroom
            for j in range(rng.randint(1, 4)):
                bp = a.unschedulable_pod(
                    name=f"seed-{i}-{j}",
                    requests={"cpu": rng.choice(["500m", "1", "2"])},
                )
                bp.metadata.uid = f"seed-uid-{i}-{j}"
                bp.metadata.creation_timestamp = 0.0
                bound.append(a.bind_pod(bp, node))
        if topo:
            # live pods seed domain counts (topology.go countDomains); some
            # carry required anti-affinity, creating INVERSE topology groups
            # that constrain even plain batch pods (topology.go:55-58)
            for j in range(rng.randint(0, 2)):
                bp_kwargs = {}
                if rng.random() < 0.25:
                    bp_kwargs["affinity"] = a.Affinity(
                        pod_anti_affinity=a.PodAntiAffinity(
                            required=[
                                a.PodAffinityTerm(
                                    topology_key=rng.choice(
                                        [a.wk.LABEL_TOPOLOGY_ZONE, a.wk.LABEL_HOSTNAME]
                                    ),
                                    label_selector=a.LabelSelector(
                                        match_labels={"app": rng.choice(APPS)}
                                    ),
                                )
                            ]
                        )
                    )
                bp = a.unschedulable_pod(
                    name=f"bound-{i}-{j}",
                    requests={"cpu": "100m"},
                    labels={"app": rng.choice(APPS)} if rng.random() < 0.8 else {},
                    **bp_kwargs,
                )
                bp.metadata.uid = f"bound-uid-{i}-{j}"
                bp.metadata.creation_timestamp = 0.0
                bound.append(a.bind_pod(bp, node))
    ds_pods = []
    if rng.random() < 0.4:
        ds = a.daemonset(requests={"cpu": "100m", "memory": "64Mi"})
        ds_pods.append(a.daemonset_pod(ds))
    n_pods = rng.randint(a.ffd.DEVICE_MIN_PODS, 320)
    shapes = [
        _random_shape(a, rng, si, topo, fused)
        for si in range(rng.randint(3, 24))
    ]
    if topo and not any(s[0].get("topology_spread_constraints") for s in shapes):
        shapes[0][0]["topology_spread_constraints"] = [_random_spread(a, rng)]
    picks = [rng.randrange(len(shapes)) for _ in range(n_pods)]

    # storage objects for volume shapes: StorageClass + one PVC per
    # volume-bearing pod (or per shared group) + CSINode attach limits on
    # some existing nodes (created BEFORE the Node so ingestion sees them)
    storage: list = []
    if topo and any(s[0].get("volume") for s in shapes):
        driver = "ebs.csi.example.com"
        storage.append(
            a.StorageClass(metadata=a.ObjectMeta(name="fast"), provisioner=driver)
        )
        pvc_names = set()
        for i, si in enumerate(picks):
            mode = shapes[si][0].get("volume")
            if mode == "own":
                pvc_names.add(f"pvc-p-{i:05d}")
            elif mode:
                pvc_names.add(f"pvc-{mode}")
        for name in sorted(pvc_names):
            storage.append(
                a.PersistentVolumeClaim(
                    metadata=a.ObjectMeta(name=name), storage_class_name="fast"
                )
            )
        limited = [
            a.CSINode(
                metadata=a.ObjectMeta(name=node.metadata.name),
                drivers=[
                    a.CSINodeDriver(name=driver, allocatable_count=rng.randint(1, 2))
                ],
            )
            for node in nodes
            if rng.random() < 0.5
        ]
        nodes = limited + nodes

    def build_pods():
        pods = []
        for i, si in enumerate(picks):
            kwargs, spec_kwargs = shapes[si]
            port = kwargs.get("host_port")
            volume = kwargs.get("volume")
            if port is not None or volume is not None:
                kwargs = {
                    k: v
                    for k, v in kwargs.items()
                    if k not in ("host_port", "volume")
                }
            p = a.unschedulable_pod(name=f"p-{i:05d}", **kwargs, **spec_kwargs)
            if port is not None:
                p.spec.containers[0].ports = [port]
            if volume is not None:
                pvc = f"pvc-p-{i:05d}" if volume == "own" else f"pvc-{volume}"
                p.spec.volumes = [a.Volume(name="data", persistent_volume_claim=pvc)]
            p.metadata.uid = f"uid-{i:05d}"
            p.metadata.creation_timestamp = float(i % 7)  # exercise uid ties
            pods.append(p)
        return pods

    return pools, storage + nodes, bound, ds_pods, build_pods


def decisions(a, results):
    claims = []
    for nc in results.new_node_claims:
        claims.append(
            (
                nc.nodepool_name,
                tuple(sorted(it.name for it in nc.instance_type_options)),
                tuple(sorted(p.metadata.name for p in nc.pods)),
                tuple(
                    sorted(
                        (
                            r.key, tuple(sorted(r.values)), r.complement,
                            r.greater_than, r.less_than, r.min_values,
                        )
                        for r in nc.requirements
                    )
                ),
                nc.annotations.get(a.wk.NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY),
            )
        )
    claims.sort()
    existing = sorted(
        (en.name(), tuple(sorted(p.metadata.name for p in en.pods)))
        for en in results.existing_nodes
        if en.pods
    )
    errors = sorted(
        (p.metadata.name, type(e).__name__, str(e)) for p, e in results.pod_errors.items()
    )
    return claims, existing, errors
