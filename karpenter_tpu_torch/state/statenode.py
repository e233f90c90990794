"""StateNode: the NodeClaim+Node pair view every solver consumes.

Mirrors the reference's pkg/controllers/state/statenode.go:108-534 —
capacity/allocatable fallback (claim status until the node initializes),
taint filtering for uninitialized managed nodes, disruption validity checks,
and per-pod usage tracking (requests, host ports, CSI volumes).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Node, Pod, Taint
from karpenter_tpu_torch.apis.nodeclaim import (
    CONDITION_INSTANCE_TERMINATING,
    NodeClaim,
)
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduling.hostportusage import HostPortUsage, get_host_ports
from karpenter_tpu_torch.scheduling.taints import KNOWN_EPHEMERAL_TAINTS, Taints
from karpenter_tpu_torch.scheduling.volumeusage import VolumeUsage, get_volumes
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.pdb import Limits
from karpenter_tpu_torch.utils.resources import ResourceList


class PodBlockEvictionError(Exception):
    """A pod on the candidate blocks eviction (statenode.go PodBlockEvictionError)."""


class StateNode:
    def __init__(self):
        self.node: Optional[Node] = None
        self.node_claim: Optional[NodeClaim] = None
        self.daemonset_requests: dict[tuple[str, str], ResourceList] = {}
        self.pod_requests: dict[tuple[str, str], ResourceList] = {}
        self.hostport_usage = HostPortUsage()
        self.volume_usage = VolumeUsage()
        self.marked_for_deletion = False
        self.nominated_until = 0.0
        # bumped on every in-place usage mutation (update_for_pod /
        # cleanup_for_pod): consumers caching node-derived statics — the
        # consolidation frontier's ExistingNode prototypes — key on it to
        # invalidate exactly when this node's usage actually moved
        self.usage_seq = 0

    # -- identity -----------------------------------------------------------

    def name(self) -> str:
        if self.node is None:
            return self.node_claim.metadata.name
        if self.node_claim is None:
            return self.node.metadata.name
        if not self.registered():
            return self.node_claim.metadata.name
        return self.node.metadata.name

    def provider_id(self) -> str:
        if self.node is None:
            return self.node_claim.status.provider_id
        return self.node.spec.provider_id

    def hostname(self) -> str:
        return self.labels().get(wk.LABEL_HOSTNAME) or self.name()

    # -- node/claim field resolution (statenode.go:237-349) -----------------

    def labels(self) -> dict[str, str]:
        if self.node is None:
            return self.node_claim.metadata.labels
        if self.node_claim is None or self.registered():
            return self.node.metadata.labels
        return self.node_claim.metadata.labels

    def annotations(self) -> dict[str, str]:
        if self.node is None:
            return self.node_claim.metadata.annotations
        if self.node_claim is None or self.registered():
            return self.node.metadata.annotations
        return self.node_claim.metadata.annotations

    def taints(self) -> Taints:
        """Effective taints; ephemeral + startup taints are invisible on
        uninitialized managed nodes so scheduling can target them
        (statenode.go:299-331)."""
        if (not self.registered() and self.managed()) or self.node is None:
            taints = list(self.node_claim.spec.taints)
        else:
            taints = list(self.node.spec.taints)
        if not self.initialized() and self.managed():
            startup = list(self.node_claim.spec.startup_taints)

            def is_transient(t: Taint) -> bool:
                return any(t.match(e) for e in KNOWN_EPHEMERAL_TAINTS) or any(
                    t.match(s) for s in startup
                )

            taints = [t for t in taints if not is_transient(t)]
        return Taints(taints)

    def managed(self) -> bool:
        return self.node_claim is not None

    def registered(self) -> bool:
        if self.managed():
            return (
                self.node is not None
                and self.node.metadata.labels.get(wk.NODE_REGISTERED_LABEL_KEY) == "true"
            )
        return True

    def initialized(self) -> bool:
        if self.managed():
            return (
                self.node is not None
                and self.node.metadata.labels.get(wk.NODE_INITIALIZED_LABEL_KEY) == "true"
            )
        return True

    def capacity(self) -> ResourceList:
        return self._resolve_resources("capacity")

    def allocatable(self) -> ResourceList:
        return self._resolve_resources("allocatable")

    def _resolve_resources(self, attr: str) -> ResourceList:
        """Until initialization, claim-status values backfill zero/missing
        node values (statenode.go:351-383)."""
        if not self.initialized() and self.node_claim is not None:
            claim_rl = getattr(self.node_claim.status, attr)
            if self.node is not None:
                out = dict(getattr(self.node.status, attr))
                for k, v in claim_rl.items():
                    if abs(out.get(k, 0.0)) < 1e-12:
                        out[k] = v
                return out
            return dict(claim_rl)
        return dict(getattr(self.node.status, attr))

    def available(self) -> ResourceList:
        return res.subtract(self.allocatable(), self.total_pod_requests())

    def total_pod_requests(self) -> ResourceList:
        return res.merge(*self.pod_requests.values())

    def total_daemonset_requests(self) -> ResourceList:
        return res.merge(*self.daemonset_requests.values())

    # -- lifecycle ----------------------------------------------------------

    def deleted(self) -> bool:
        if self.node_claim is not None:
            if self.node_claim.metadata.deletion_timestamp is not None:
                return True
            if self.node_claim.condition_is_true(CONDITION_INSTANCE_TERMINATING):
                return True
        return (
            self.node is not None
            and self.node_claim is None
            and self.node.metadata.deletion_timestamp is not None
        )

    def is_marked_for_deletion(self) -> bool:
        return self.marked_for_deletion or self.deleted()

    def nominate(self, now: float, window: float) -> None:
        self.nominated_until = now + window

    def nominated(self, now: float) -> bool:
        return self.nominated_until > now

    # -- pods ---------------------------------------------------------------

    def pods(self, store: Store) -> list[Pod]:
        if self.node is None:
            return []
        return store.pods_on_node(self.node.metadata.name)

    def reschedulable_pods(self, store: Store) -> list[Pod]:
        return [p for p in self.pods(store) if podutil.is_reschedulable(p)]

    def currently_reschedulable_pods(self, store: Store, pdbs: Limits) -> list[Pod]:
        return [p for p in self.pods(store) if pdbs.is_currently_reschedulable(p)]

    # -- disruption validity (statenode.go:202-262) -------------------------

    def validate_node_disruptable(self, now: float) -> None:
        """Raises ValueError if this node can't be a disruption candidate."""
        if self.node_claim is None:
            raise ValueError("node isn't managed by karpenter")
        if self.node is None:
            raise ValueError("nodeclaim does not have an associated node")
        if not self.initialized():
            raise ValueError("node isn't initialized")
        if self.is_marked_for_deletion():
            raise ValueError("node is deleting or marked for deletion")
        if self.nominated(now):
            raise ValueError("node is nominated for a pending pod")
        if self.annotations().get(wk.DO_NOT_DISRUPT_ANNOTATION_KEY) == "true":
            raise ValueError(
                f'disruption is blocked through the "{wk.DO_NOT_DISRUPT_ANNOTATION_KEY}" annotation'
            )
        if wk.NODEPOOL_LABEL_KEY not in self.labels():
            raise ValueError(f"node doesn't have required label {wk.NODEPOOL_LABEL_KEY}")

    def validate_pods_disruptable(self, store: Store, pdbs: Limits) -> list[Pod]:
        """Raises PodBlockEvictionError if a pod blocks; returns the pods."""
        pods = self.pods(store)
        for p in pods:
            if not podutil.is_disruptable(p):
                raise PodBlockEvictionError(
                    f'pod {p.metadata.namespace}/{p.metadata.name} has '
                    f'"{wk.DO_NOT_DISRUPT_ANNOTATION_KEY}" annotation'
                )
        pdb_keys, ok = pdbs.can_evict_pods(pods)
        if not ok:
            raise PodBlockEvictionError(f"pdb prevents pod evictions: {pdb_keys}")
        return pods

    # -- usage tracking -----------------------------------------------------

    def update_for_pod(self, store: Store, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        from karpenter_tpu_torch.apis.core import pod_resource_requests

        self.pod_requests[key] = pod_resource_requests(pod)
        if podutil.is_owned_by_daemon_set(pod):
            self.daemonset_requests[key] = pod_resource_requests(pod)
        self.hostport_usage.add(pod, get_host_ports(pod))
        self.volume_usage.add(pod, get_volumes(store, pod))
        self.usage_seq += 1

    def cleanup_for_pod(self, namespace: str, name: str) -> None:
        self.hostport_usage.delete_pod(namespace, name)
        self.volume_usage.delete_pod(namespace, name)
        self.pod_requests.pop((namespace, name), None)
        self.daemonset_requests.pop((namespace, name), None)
        self.usage_seq += 1

    def deep_copy(self) -> "StateNode":
        """Copy with independent usage tracking, for scheduling simulations
        (reference Cluster.Nodes() deep-copies, cluster.go:203-209): the
        solver mutates hostports/volumes/requests on its copy, never the
        live mirror. The Node/NodeClaim objects stay shared — simulations
        only read them."""
        out = StateNode.__new__(StateNode)
        out.node = self.node
        out.node_claim = self.node_claim
        out.daemonset_requests = {k: dict(v) for k, v in self.daemonset_requests.items()}
        out.pod_requests = {k: dict(v) for k, v in self.pod_requests.items()}
        out.hostport_usage = self.hostport_usage.copy()
        out.volume_usage = self.volume_usage.copy()
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        out.usage_seq = self.usage_seq
        return out

    def shallow_copy(self) -> "StateNode":
        out = StateNode.__new__(StateNode)
        out.node = self.node
        out.node_claim = self.node_claim
        out.daemonset_requests = self.daemonset_requests
        out.pod_requests = self.pod_requests
        out.hostport_usage = self.hostport_usage
        out.volume_usage = self.volume_usage
        out.marked_for_deletion = self.marked_for_deletion
        out.nominated_until = self.nominated_until
        out.usage_seq = self.usage_seq
        return out

    def __repr__(self) -> str:
        return f"StateNode({self.name()!r}, pid={self.provider_id()!r})"


def active(nodes: list[StateNode]) -> list[StateNode]:
    """Nodes eligible as scheduling targets (statenode.go StateNodes.Active)."""
    return [n for n in nodes if not n.is_marked_for_deletion()]


def deleting(nodes: list[StateNode]) -> list[StateNode]:
    return [n for n in nodes if n.is_marked_for_deletion()]


def require_no_schedule_taint(store: Store, add: bool, *nodes: StateNode) -> None:
    """Add/remove the karpenter.sh/disrupted:NoSchedule taint on the Node
    objects (statenode.go:483-534). Idempotent; deleting nodes keep it."""
    from karpenter_tpu_torch.scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT

    for sn in nodes:
        if sn.node is None or sn.node_claim is None:
            continue
        node = store.try_get("Node", sn.node.metadata.name)
        if node is None:
            continue
        has = any(t.match(DISRUPTED_NO_SCHEDULE_TAINT) for t in node.spec.taints)
        if has and node.metadata.deletion_timestamp is not None:
            continue
        if not add and has:
            node.spec.taints = [
                t for t in node.spec.taints if not t.match(DISRUPTED_NO_SCHEDULE_TAINT)
            ]
            store.update(node)
        elif add and not has:
            node.spec.taints = list(node.spec.taints) + [DISRUPTED_NO_SCHEDULE_TAINT]
            store.update(node)


def clear_node_claims_condition(store: Store, condition_type: str, *nodes: StateNode) -> None:
    """Strip a status condition from the nodes' NodeClaims
    (statenode.go ClearNodeClaimsCondition)."""
    for sn in nodes:
        if sn.node_claim is None:
            continue
        claim = store.try_get("NodeClaim", sn.node_claim.metadata.name)
        if claim is None or claim.get_condition(condition_type) is None:
            continue
        claim.clear_condition(condition_type)
        store.update(claim)
