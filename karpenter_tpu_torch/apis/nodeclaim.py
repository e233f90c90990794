"""NodeClaim API type (reference pkg/apis/v1/nodeclaim.go:30-78 and
nodeclaim_status.go:25-70)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.apis.conditions import ConditionedStatus
from karpenter_tpu_torch.apis.core import Condition, ObjectMeta, Taint
from karpenter_tpu_torch.utils.resources import ResourceList

# Status condition types (nodeclaim_status.go:26-35)
CONDITION_LAUNCHED = "Launched"
CONDITION_REGISTERED = "Registered"
CONDITION_INITIALIZED = "Initialized"
CONDITION_CONSOLIDATABLE = "Consolidatable"
CONDITION_DRIFTED = "Drifted"
CONDITION_DRAINED = "Drained"
CONDITION_VOLUMES_DETACHED = "VolumesDetached"
CONDITION_INSTANCE_TERMINATING = "InstanceTerminating"
CONDITION_CONSISTENT_STATE_FOUND = "ConsistentStateFound"
CONDITION_DISRUPTION_REASON = "DisruptionReason"
CONDITION_READY = "Ready"

LIVENESS_CONDITIONS = (CONDITION_LAUNCHED, CONDITION_REGISTERED, CONDITION_INITIALIZED)


@dataclass
class NodeClassRef:
    group: str = ""
    kind: str = ""
    name: str = ""


@dataclass
class ResourceRequirements:
    requests: ResourceList = field(default_factory=dict)


@dataclass
class NodeClaimSpec:
    """NodeClaim desired state (nodeclaim.go:30-78)."""

    # NodeSelectorRequirement-shaped dicts with optional minValues
    requirements: list[dict] = field(default_factory=list)
    resources: ResourceRequirements = field(default_factory=ResourceRequirements)
    taints: list[Taint] = field(default_factory=list)
    startup_taints: list[Taint] = field(default_factory=list)
    node_class_ref: NodeClassRef = field(default_factory=NodeClassRef)
    termination_grace_period: Optional[float] = None  # seconds
    expire_after: Optional[float] = None  # seconds; None = Never


@dataclass
class NodeClaimStatus:
    provider_id: str = ""
    image_id: str = ""
    node_name: str = ""
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: list[Condition] = field(default_factory=list)
    last_pod_event_time: float = 0.0


@dataclass(eq=False)
class NodeClaim(ConditionedStatus):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeClaimSpec = field(default_factory=NodeClaimSpec)
    status: NodeClaimStatus = field(default_factory=NodeClaimStatus)

    KIND = "NodeClaim"
