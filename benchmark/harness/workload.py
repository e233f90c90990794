"""The program-side workload functions: frozen copies of chip_smoke.py's,
rewritten to take the configuration's numbers and the generator's demands
(so the run's seed reaches them through `--seed`). chip_smoke.py itself
is left as it is; this module never imports it.

Sources, chip_smoke.py at the commit this benchmark was added on:
- `build_catalog`: :898-915 (`build_catalog`), the kwok types made from
  the configuration's numbers rather than taken from the port's provider;
- `pending_pod`: :953-962 (`_pending_pod`), one demand at a time, its
  labels in place of a node selector;
- `SolveContext`: :1068-1112 (`solve`, `scheduler_for`), the store, cluster
  and pools built once, the Topology and Scheduler per solve;
- `decisions`: :1115-1138, errors by uid (the reference decides which pods
  fail, not the message).
"""

from __future__ import annotations


def build_catalog(spec: dict):
    """The program's InstanceType objects for the catalog the configuration
    states, as the kwok generator makes them (the port's
    cloudprovider/kwok/instance_types.py, upstream
    kwok/tools/gen_instance_types.go:70-110): for each cpu size, family,
    os and arch a type with one available offering per zone and capacity
    type; then `repeat` - 1 copies named `<name>-r<k>`. The reference's
    catalog reads the same numbers."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cloudprovider.types import (
        InstanceType, InstanceTypeOverhead, Offering, Offerings,
    )
    from karpenter_tpu_torch.scheduling.requirements import Operator, Requirement, Requirements

    keys, price, kube = spec["labels"], spec["price"], spec["kube_reserved"]
    gib = float(2**30)

    def req(key, values):
        return Requirement(keys[key], Operator.IN, list(values))

    base = []
    for cpu in spec["cpu_sizes"]:
        for family, ratio in spec["families"].items():
            for os_name in spec["oses"]:
                for arch in spec["archs"]:
                    mem_gib = cpu * ratio
                    name = f"{family}-{cpu}x-{arch}-{os_name}"
                    base.append(InstanceType(
                        name=name,
                        requirements=Requirements(
                            req("instance_type", [name]), req("arch", [arch]), req("os", [os_name]),
                            req("zone", spec["zones"]), req("capacity_type", spec["capacity_types"]),
                            req("size", [f"{cpu}x"]), req("family", [family]),
                        ),
                        offerings=Offerings(
                            Offering(requirements=Requirements(req("capacity_type", [ct]), req("zone", [zone])),
                                     price=_price(price, cpu, mem_gib, ct), available=True)
                            for zone in spec["zones"] for ct in spec["capacity_types"]
                        ),
                        capacity={
                            wk.RESOURCE_CPU: float(cpu),
                            wk.RESOURCE_MEMORY: mem_gib * gib,
                            wk.RESOURCE_PODS: float(spec["pods"]),
                            wk.RESOURCE_EPHEMERAL_STORAGE: spec["ephemeral_storage_gib"] * gib,
                        },
                        overhead=InstanceTypeOverhead(kube_reserved={
                            wk.RESOURCE_CPU: kube["cpu"], wk.RESOURCE_MEMORY: kube["memory_gib"] * gib,
                        }),
                    ))
    catalog = list(base)
    for r in range(1, spec["repeat"]):
        for it in base:
            catalog.append(InstanceType(name=f"{it.name}-r{r}", requirements=it.requirements,
                                        offerings=it.offerings, capacity=it.capacity, overhead=it.overhead))
    return catalog


def _price(price: dict, cpu: float, mem_gib: float, capacity_type: str) -> float:
    p = price["per_cpu"] * cpu + price["per_gib"] * mem_gib
    return round(p * price["spot_factor"] if capacity_type == "spot" else p, 6)


class PodFactory:
    """Program Pod objects for the generator's demands: each shape's
    requests parsed once by the program's parser, each pod a new object."""

    def __init__(self, shapes):
        from karpenter_tpu_torch.utils.resources import parse_resource_list

        self.shapes = [(labels, parse_resource_list({"cpu": cpu, "memory": mem}))
                       for labels, cpu, mem in shapes]

    def pods(self, demands) -> list:
        return [pending_pod(d.uid, d.uid, *self.shapes[d.shape], d.ts) for d in demands]


def pending_pod(name, uid, labels, requests, ts):
    from karpenter_tpu_torch.apis.core import Condition, Container, ObjectMeta, Pod, PodSpec

    pod = Pod(
        metadata=ObjectMeta(name=name, uid=uid, labels=dict(labels)),
        spec=PodSpec(containers=[Container(requests=dict(requests))]),
    )
    pod.metadata.creation_timestamp = ts
    pod.status.conditions.append(Condition(type="PodScheduled", status="False", reason="Unschedulable"))
    return pod


class SolveContext:
    """An empty cluster with the configuration's NodePools, built once; a
    Topology and a Scheduler over it per solve."""

    def __init__(self, pools_spec, catalog, engine):
        from karpenter_tpu_torch.apis.core import ObjectMeta
        from karpenter_tpu_torch.apis.nodepool import NodePool
        from karpenter_tpu_torch.events.recorder import Recorder
        from karpenter_tpu_torch.runtime.store import Store
        from karpenter_tpu_torch.state.cluster import Cluster
        from karpenter_tpu_torch.utils.clock import FakeClock
        from karpenter_tpu_torch.utils.resources import parse_resource_list

        self.clock = FakeClock()
        self.store = Store(clock=self.clock)
        self.cluster = Cluster(self.clock, self.store, cloud_provider=None)
        self.pools = []
        for spec in sorted(pools_spec, key=lambda p: -(p["weight"] or 0)):
            pool = NodePool(metadata=ObjectMeta(name=spec["name"]))
            if spec["weight"] is not None:
                pool.spec.weight = spec["weight"]
            if spec["limits"]:
                pool.spec.limits = parse_resource_list(spec["limits"])
            pool.set_condition("Ready", "True")
            self.store.create(pool)
            self.pools.append(pool)
        self.state_nodes = self.cluster.state_nodes()
        self.its = {pool.metadata.name: catalog for pool in self.pools}
        self.recorder = Recorder(clock=self.clock)
        self.engine = engine

    def scheduler(self, pods):
        from karpenter_tpu_torch.scheduler.scheduler import Scheduler
        from karpenter_tpu_torch.scheduler.topology import Topology

        topology = Topology(self.store, self.cluster, self.state_nodes, self.pools, self.its, pods)
        return Scheduler(
            self.store, self.pools, self.cluster, self.state_nodes, topology, self.its, [],
            self.recorder, self.clock, engine=self.engine,
        )


def decisions(results, uid=lambda u: u) -> dict:
    """What a solve decided, in the reference's form; `uid` maps each pod's
    uid (a batch's pass prefix stripped)."""
    claims = sorted(
        (
            tuple(sorted(uid(p.metadata.uid) for p in nc.pods)),
            tuple(sorted(it.name for it in nc.instance_type_options)),
            tuple(
                sorted(
                    (r.key, r.complement, tuple(sorted(r.values)), r.greater_than,
                     r.less_than, r.min_values)
                    for r in nc.requirements
                )
            ),
        )
        for nc in results.new_node_claims
    )
    errors = sorted(uid(p.metadata.uid) for p in results.pod_errors)
    joins = sorted(
        (en.name(), tuple(sorted(uid(p.metadata.uid) for p in en.pods)))
        for en in results.existing_nodes if en.pods
    )
    return {"claims": claims, "errors": errors, "joins": joins}
