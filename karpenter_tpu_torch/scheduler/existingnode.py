"""ExistingNode: scheduling simulation view of a live/in-flight node.

Mirrors the reference's scheduling/existingnode.go:29-101, with two
departures that the consolidation frontier search rides:

Copy-on-write usage. The reference mutates its (deep-copied) StateNode's
hostport/volume usage as pods join; this ExistingNode instead forks those
two objects onto ITSELF at the first write and never touches the
StateNode. A scheduling solve is therefore a pure reader of StateNode —
which is what lets k concurrent frontier probes (and the sequential
simulate path) share ONE node snapshot instead of deep-copying the whole
cluster per probe. Reads before the first write see the shared, pristine
state; reads after it see this solve's fork.

Prototypes. Everything `__init__` derives from the StateNode — taints,
daemon headroom, the label-requirement set — is identical for every probe
of one consolidation pass, and building it per probe dominated scheduler
construction at 1k nodes. `build_node_prototypes` hoists that work out
once; `from_prototype` stamps a per-solve ExistingNode from it in a few
attribute writes. The shared prototype fields are safe to alias because
every mutation path REBINDS them (`add` builds fresh Requirements /
resource dicts) — nothing writes through the shared objects.
"""

from __future__ import annotations

from typing import Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod, Taint
from karpenter_tpu_torch.scheduler.topology import Topology
from karpenter_tpu_torch.scheduling.hostportusage import get_host_ports
from karpenter_tpu_torch.scheduling.requirements import (
    Operator,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.scheduling.volumeusage import Volumes
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList


class ExistingNode:
    def __init__(
        self,
        state_node: StateNode,
        topology: Topology,
        taints: Sequence[Taint],
        daemon_resources: ResourceList,
    ):
        self.state_node = state_node
        self.topology = topology
        self.cached_taints = list(taints)
        self.pods: list[Pod] = []
        self._sort_key = None  # computed lazily via sort_key()
        # usage forks (copy-on-write): None -> read the StateNode's shared
        # objects; set -> this solve wrote and owns private copies
        self._forked_hostports = None
        self._forked_volumes = None
        # Daemon resources not yet accounted on the node still need headroom
        # (existingnode.go:41-48).
        pending_daemons = res.non_negative(
            res.subtract(daemon_resources, state_node.total_daemonset_requests())
        )
        available = state_node.available()
        self.cached_available = available
        self.remaining_resources = res.subtract(available, pending_daemons)
        self.requirements = Requirements.from_labels(state_node.labels())
        self.requirements.add(
            Requirement(wk.LABEL_HOSTNAME, Operator.IN, [state_node.hostname()])
        )
        topology.register(wk.LABEL_HOSTNAME, state_node.hostname())

    @classmethod
    def from_prototype(
        cls, proto: "ExistingNodePrototype", topology: Topology
    ) -> "ExistingNode":
        """Stamp a per-solve instance from precomputed statics — the
        frontier's fast path. Only the per-solve topology registration and
        the mutable slots are fresh; every shared field is rebind-only."""
        en = cls.__new__(cls)
        en.state_node = proto.state_node
        en.topology = topology
        en.cached_taints = proto.taints
        en.pods = []
        en._forked_hostports = None
        en._forked_volumes = None
        en.cached_available = proto.available
        en.remaining_resources = proto.remaining
        en.requirements = proto.base_requirements
        en._sort_key = proto.sort_key
        # register() is a no-op scan when the solve has no topology groups
        # at all — the common consolidation shape; skipping the call x 1k
        # nodes x k probes is measurable
        if topology.topology_groups or topology.inverse_topology_groups:
            topology.register(wk.LABEL_HOSTNAME, proto.hostname)
        return en

    # -- copy-on-write usage -------------------------------------------------

    @property
    def hostport_usage(self):
        if self._forked_hostports is not None:
            return self._forked_hostports
        return self.state_node.hostport_usage

    @property
    def volume_usage(self):
        if self._forked_volumes is not None:
            return self._forked_volumes
        return self.state_node.volume_usage

    def fork_usage(self) -> None:
        """Take private usage copies before the first write; idempotent."""
        if self._forked_volumes is None:
            self._forked_hostports = self.state_node.hostport_usage.copy()
            self._forked_volumes = self.state_node.volume_usage.copy()

    def usage_snapshot(self):
        """Opaque usage state for rollback (device-solve abort): the fork
        contents at snapshot time, or None when still unforked."""
        if self._forked_volumes is None:
            return None
        return (self._forked_hostports.copy(), self._forked_volumes.copy())

    def restore_usage(self, snapshot) -> None:
        if snapshot is None:
            self._forked_hostports = None
            self._forked_volumes = None
        else:
            self._forked_hostports, self._forked_volumes = snapshot

    def sort_key(self) -> tuple:
        """(uninitialized-last, name) — Scheduler's existing-node order,
        precomputed on the prototype path so the per-probe sort doesn't
        re-chase labels through the StateNode."""
        if self._sort_key is None:
            self._sort_key = (not self.initialized(), self.name())
        return self._sort_key

    # pass-throughs
    def name(self) -> str:
        return self.state_node.name()

    def provider_id(self) -> str:
        return self.state_node.provider_id()

    def initialized(self) -> bool:
        return self.state_node.initialized()

    def managed(self) -> bool:
        return self.state_node.managed()

    def labels(self) -> dict[str, str]:
        return self.state_node.labels()

    @property
    def node_claim(self):
        return self.state_node.node_claim

    def can_add(self, pod: Pod, pod_data, volumes: Volumes) -> Requirements:
        """Raises on infeasibility; returns updated node requirements
        (existingnode.go:63-88)."""
        err = Taints(self.cached_taints).tolerates_pod(pod)
        if err is not None:
            raise ValueError(err)
        vol_err = self.volume_usage.exceeds_limits(volumes)
        if vol_err is not None:
            raise ValueError(f"checking volume usage, {vol_err}")
        hostports = get_host_ports(pod)
        conflict = self.hostport_usage.conflicts(pod, hostports)
        if conflict is not None:
            raise ValueError(f"checking host port usage, {conflict}")
        if not res.fits(pod_data.requests, self.remaining_resources):
            raise ValueError("exceeds node resources")
        compat_err = self.requirements.compatible(pod_data.requirements)
        if compat_err is not None:
            raise ValueError(compat_err)
        node_requirements = Requirements(*self.requirements.values())
        node_requirements.add(*pod_data.requirements.values())

        topology_requirements = self.topology.add_requirements(
            pod, self.cached_taints, pod_data.strict_requirements, node_requirements
        )
        topo_err = node_requirements.compatible(topology_requirements)
        if topo_err is not None:
            raise ValueError(topo_err)
        node_requirements.add(*topology_requirements.values())
        return node_requirements

    def add(self, pod: Pod, pod_data, node_requirements: Requirements, volumes: Volumes) -> None:
        self.pods.append(pod)
        self.remaining_resources = res.subtract(self.remaining_resources, pod_data.requests)
        self.requirements = node_requirements
        self.topology.record(pod, self.cached_taints, node_requirements)
        self.fork_usage()
        self._forked_hostports.add(pod, get_host_ports(pod))
        self._forked_volumes.add(pod, volumes)


class ExistingNodePrototype:
    """The StateNode-derived statics of an ExistingNode, computed once per
    consolidation pass and shared by every probe's scheduler."""

    __slots__ = (
        "state_node",
        "taints",
        "available",
        "remaining",
        "base_requirements",
        "hostname",
        "capacity",
        "pool_name",
        "sort_key",
        "cache_key",
        "source_node",
        "source_claim",
    )

    def __init__(self, state_node: StateNode, daemon_resources: ResourceList):
        self.cache_key = None
        # identity anchors for the cross-pass cache: holding the REAL
        # objects (not their ids) keeps them alive while cached, so the
        # `is` comparisons below can never be fooled by address reuse
        self.source_node = state_node.node
        self.source_claim = state_node.node_claim
        self.state_node = state_node
        self.taints = list(state_node.taints())
        pending_daemons = res.non_negative(
            res.subtract(daemon_resources, state_node.total_daemonset_requests())
        )
        available = state_node.available()
        self.available = available
        self.remaining = res.subtract(available, pending_daemons)
        self.base_requirements = Requirements.from_labels(state_node.labels())
        self.hostname = state_node.hostname()
        self.base_requirements.add(
            Requirement(wk.LABEL_HOSTNAME, Operator.IN, [self.hostname])
        )
        self.capacity = state_node.capacity()
        self.pool_name = state_node.labels().get(wk.NODEPOOL_LABEL_KEY, "")
        self.sort_key = (not state_node.initialized(), state_node.name())


def build_node_prototypes(
    state_nodes: Sequence[StateNode],
    daemonset_pods: Sequence[Pod],
    cache: Optional[dict] = None,
) -> dict[str, "ExistingNodePrototype"]:
    """Precompute per-node scheduler statics (the body of
    Scheduler._calculate_existing_nodes) for every node once, keyed by node
    name.

    With `cache` (a dict the caller keeps across passes — the provisioner
    hangs one off itself for the consolidation frontier), prototypes
    survive reconcile passes: a node whose prototype inputs haven't moved
    reuses last pass's object. Validation captures every input exactly —
    StateNode identity (informer updates REPLACE StateNodes), the Node /
    NodeClaim objects by IDENTITY against hard refs the prototype keeps
    alive (the rare in-place rebind; holding the refs makes address reuse
    unexploitable), usage_seq (pod add/remove mutate requests in place),
    and a content signature of the daemonset pods (template resources feed
    daemon headroom) — so a stale hit is impossible: any drift misses and
    rebuilds."""
    from karpenter_tpu_torch.apis.core import pod_resource_requests
    from karpenter_tpu_torch.scheduling.requirements import strict_pod_requirements

    daemon_sig = tuple(
        sorted(
            (
                p.metadata.namespace,
                p.metadata.name,
                tuple(sorted(pod_resource_requests(p).items())),
            )
            for p in daemonset_pods
        )
    )
    prototypes: dict[str, ExistingNodePrototype] = {}
    for node in state_nodes:
        key = (node.usage_seq, daemon_sig)
        name = node.name()
        if cache is not None:
            prev = cache.get(name)
            if (
                prev is not None
                and prev.cache_key == key
                # identity, not id(): the prototype holds hard refs to the
                # exact objects it was derived from, so a freed-and-reused
                # address can never produce a false hit
                and prev.state_node is node
                and prev.source_node is node.node
                and prev.source_claim is node.node_claim
            ):
                prototypes[name] = prev
                continue
        daemons = []
        if daemonset_pods:
            node_taints = Taints(node.taints())
            node_reqs = Requirements.from_labels(node.labels())
            for p in daemonset_pods:
                if node_taints.tolerates_pod(p) is not None:
                    continue
                if not node_reqs.is_compatible(strict_pod_requirements(p)):
                    continue
                daemons.append(p)
        proto = ExistingNodePrototype(
            node, res.merge(*(pod_resource_requests(p) for p in daemons))
        )
        proto.cache_key = key
        prototypes[name] = proto
    if cache is not None:
        # the new map IS the next pass's cache: departed nodes fall out
        cache.clear()
        cache.update(prototypes)
    return prototypes
