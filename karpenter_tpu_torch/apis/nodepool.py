"""NodePool API type (reference pkg/apis/v1/nodepool.go:39-276)."""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.apis.conditions import ConditionedStatus
from karpenter_tpu_torch.apis.core import ObjectMeta
from karpenter_tpu_torch.apis.nodeclaim import NodeClaimSpec
from karpenter_tpu_torch.utils.resources import ResourceList

CONSOLIDATION_POLICY_WHEN_EMPTY = "WhenEmpty"
CONSOLIDATION_POLICY_WHEN_EMPTY_OR_UNDERUTILIZED = "WhenEmptyOrUnderutilized"

DISRUPTION_REASON_UNDERUTILIZED = "Underutilized"
DISRUPTION_REASON_EMPTY = "Empty"
DISRUPTION_REASON_DRIFTED = "Drifted"

NODEPOOL_HASH_VERSION = "v1"

# NodePool status conditions (nodepool_status.go:24-52)
CONDITION_VALIDATION_SUCCEEDED = "ValidationSucceeded"
CONDITION_NODECLASS_READY = "NodeClassReady"
CONDITION_NODE_REGISTRATION_HEALTHY = "NodeRegistrationHealthy"
CONDITION_READY = "Ready"


@dataclass
class Budget:
    """Max simultaneously-disrupting nodes, optionally cron-windowed
    (nodepool.go:90-122)."""

    nodes: str = "10%"  # int string or percentage
    reasons: list[str] = field(default_factory=list)  # empty = all reasons
    schedule: Optional[str] = None  # cron; None = always active
    duration: Optional[float] = None  # seconds; required with schedule

    def allowed_disruptions(self, total_nodes: int, now: float) -> int:
        """Resolve the budget to a node count at `now` (inactive = unlimited).

        Percentages round UP so a small nodepool is never permanently
        blocked by the default 10% budget (reference nodepool.go:333-338);
        a schedule without a duration is invalid and fails closed
        (nodepool.go:324-329).
        """
        if self.schedule is not None and self.duration is None:
            return 0
        if not self.is_active(now):
            return total_nodes  # no restriction from an inactive budget
        if self.nodes.endswith("%"):
            pct = int(self.nodes[:-1])
            return int(math.ceil(total_nodes * pct / 100.0))
        return int(self.nodes)

    def is_active(self, now: float) -> bool:
        if self.schedule is None:
            return True
        from karpenter_tpu_torch.utils.cron import last_fire_time

        start = last_fire_time(self.schedule, now)
        if start is None:
            return False
        return now - start < (self.duration or 0.0)


@dataclass
class Disruption:
    consolidate_after: Optional[float] = 0.0  # seconds; None = Never
    consolidation_policy: str = CONSOLIDATION_POLICY_WHEN_EMPTY_OR_UNDERUTILIZED
    budgets: list[Budget] = field(default_factory=lambda: [Budget(nodes="10%")])


@dataclass
class NodeClaimTemplate:
    """Template stamped onto launched NodeClaims (nodepool.go:141-186)."""

    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)


@dataclass
class NodePoolSpec:
    template: NodeClaimTemplate = field(default_factory=NodeClaimTemplate)
    disruption: Disruption = field(default_factory=Disruption)
    limits: ResourceList = field(default_factory=dict)
    weight: int = 0


@dataclass
class NodePoolStatus:
    resources: ResourceList = field(default_factory=dict)
    node_count: int = 0
    conditions: list = field(default_factory=list)


@dataclass(eq=False)
class NodePool(ConditionedStatus):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodePoolSpec = field(default_factory=NodePoolSpec)
    status: NodePoolStatus = field(default_factory=NodePoolStatus)

    KIND = "NodePool"

    def static_hash(self) -> str:
        """Hash of drift-relevant static fields (nodepool.go hash tags:
        everything under template except ignored fields; reference
        nodepool/hash controller)."""
        spec = self.spec.template.spec
        payload = {
            "labels": self.spec.template.labels,
            "annotations": self.spec.template.annotations,
            "taints": [(t.key, t.value, t.effect) for t in spec.taints],
            "startup_taints": [(t.key, t.value, t.effect) for t in spec.startup_taints],
            "node_class_ref": (
                spec.node_class_ref.group,
                spec.node_class_ref.kind,
                spec.node_class_ref.name,
            ),
            "expire_after": spec.expire_after,
            "termination_grace_period": spec.termination_grace_period,
        }
        return hashlib.sha256(
            json.dumps(payload, sort_keys=True, default=str).encode()
        ).hexdigest()[:16]

    def allowed_disruptions(self, reason: str, total_nodes: int, now: float) -> int:
        """Most-restrictive active budget for the reason (nodepool.go:61-68)."""
        allowed = total_nodes
        for budget in self.spec.disruption.budgets:
            if budget.reasons and reason not in budget.reasons:
                continue
            allowed = min(allowed, budget.allowed_disruptions(total_nodes, now))
        return allowed
