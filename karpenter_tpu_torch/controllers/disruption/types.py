"""Disruption candidates, commands and cost model.

Mirrors the reference's disruption/types.go:46-215 and
pkg/utils/disruption/disruption.go (eviction cost, lifetime scaling).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.state.statenode import PodBlockEvictionError, StateNode
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.pdb import Limits

if TYPE_CHECKING:
    from karpenter_tpu_torch.scheduler.nodeclaim import NodeClaim as SchedNodeClaim
    from karpenter_tpu_torch.scheduler.scheduler import Results

GRACEFUL_DISRUPTION_CLASS = "graceful"
EVENTUAL_DISRUPTION_CLASS = "eventual"

DECISION_NOOP = "no-op"
DECISION_REPLACE = "replace"
DECISION_DELETE = "delete"

POD_DELETION_COST_ANNOTATION = "controller.kubernetes.io/pod-deletion-cost"


def eviction_cost(pod: Pod) -> float:
    """disruption.go:46-63: base 1.0, scaled by deletion-cost annotation and
    priority, clamped to [-10, 10]."""
    cost = 1.0
    raw = pod.metadata.annotations.get(POD_DELETION_COST_ANNOTATION)
    if raw is not None:
        try:
            cost += float(raw) / (2.0**27)
        except ValueError:
            pass
    if pod.spec.priority is not None:
        cost += float(pod.spec.priority) / (2.0**25)
    return max(-10.0, min(10.0, cost))


def rescheduling_cost(pods: list[Pod]) -> float:
    return sum(eviction_cost(p) for p in pods)


def lifetime_remaining(clock: Clock, node_claim) -> float:
    """Fraction of expireAfter lifetime left (disruption.go:34-44): nodes
    near expiry are cheap to disrupt."""
    if node_claim is None or node_claim.spec.expire_after is None:
        return 1.0
    total = node_claim.spec.expire_after
    if total <= 0:
        return 1.0
    age = clock.since(node_claim.metadata.creation_timestamp)
    return max(0.0, min(1.0, (total - age) / total))


class Candidate:
    """A disruptable node (types.go:71-120)."""

    def __init__(
        self,
        state_node: StateNode,
        node_pool: NodePool,
        instance_type: Optional[InstanceType],
        reschedulable_pods: list[Pod],
        disruption_cost: float,
    ):
        self.state_node = state_node
        self.node_pool = node_pool
        self.instance_type = instance_type
        self.reschedulable_pods = reschedulable_pods
        self.disruption_cost = disruption_cost
        labels = state_node.labels()
        self.capacity_type = labels.get(wk.CAPACITY_TYPE_LABEL_KEY, "")
        self.zone = labels.get(wk.LABEL_TOPOLOGY_ZONE, "")

    def name(self) -> str:
        return self.state_node.name()

    def provider_id(self) -> str:
        return self.state_node.provider_id()

    @property
    def node_claim(self):
        return self.state_node.node_claim

    def labels(self) -> dict[str, str]:
        return self.state_node.labels()


def new_candidate(
    store,
    recorder: Recorder,
    clock: Clock,
    node: StateNode,
    pdbs: Limits,
    nodepool_map: dict[str, NodePool],
    nodepool_instance_types: dict[str, dict[str, InstanceType]],
    queue,
    disruption_class: str,
) -> Candidate:
    """Builds a Candidate or raises (types.go:83-120)."""
    if queue is not None and queue.has_any(node.provider_id()):
        raise ValueError("candidate is already being disrupted")
    try:
        node.validate_node_disruptable(clock.now())
    except ValueError as e:
        if node.node_claim is not None:
            recorder.publish(
                Event(node.node_claim, "Normal", "DisruptionBlocked", str(e))
            )
        raise
    nodepool_name = node.labels().get(wk.NODEPOOL_LABEL_KEY, "")
    node_pool = nodepool_map.get(nodepool_name)
    instance_type_map = nodepool_instance_types.get(nodepool_name)
    if node_pool is None or instance_type_map is None:
        recorder.publish(
            Event(
                node.node_claim,
                "Normal",
                "DisruptionBlocked",
                f"NodePool not found (NodePool={nodepool_name})",
            )
        )
        raise ValueError(f"nodepool {nodepool_name!r} not found")
    instance_type = instance_type_map.get(node.labels().get(wk.LABEL_INSTANCE_TYPE, ""))
    try:
        pods = node.validate_pods_disruptable(store, pdbs)
    except PodBlockEvictionError as e:
        # Eventual disruption (drift/expiration with a TGP) proceeds despite
        # blocking pods (types.go:104-109).
        eventual = (
            node.node_claim is not None
            and node.node_claim.spec.termination_grace_period is not None
            and disruption_class == EVENTUAL_DISRUPTION_CLASS
        )
        if not eventual:
            recorder.publish(
                Event(node.node_claim, "Normal", "DisruptionBlocked", str(e))
            )
            raise
        pods = node.pods(store)
    reschedulable = [p for p in pods if podutil.is_reschedulable(p)]
    cost = rescheduling_cost(pods) * lifetime_remaining(clock, node.node_claim)
    return Candidate(node, node_pool, instance_type, reschedulable, cost)


@dataclass
class Replacement:
    node_claim: "SchedNodeClaim"
    name: str = ""
    initialized: bool = False


@dataclass
class Command:
    method: Optional[object] = None
    succeeded: bool = False
    creation_timestamp: float = 0.0
    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    results: Optional["Results"] = None
    candidates: list[Candidate] = field(default_factory=list)
    replacements: list[Replacement] = field(default_factory=list)

    def decision(self) -> str:
        if self.candidates and self.replacements:
            return DECISION_REPLACE
        if self.candidates:
            return DECISION_DELETE
        return DECISION_NOOP

    @property
    def reason(self) -> str:
        return self.method.reason() if self.method else ""


def replacements_from_node_claims(node_claims) -> list[Replacement]:
    return [Replacement(node_claim=nc) for nc in node_claims]
