"""Core object model: the subset of Kubernetes core/v1 shapes the framework
consumes, as plain dataclasses (no apimachinery).

These mirror the fields the reference reads from corev1 objects (Pod spec
scheduling fields, Node capacity/taints, PDBs, DaemonSets); everything else
is intentionally omitted.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Optional

from karpenter_tpu_torch.utils import resources as r
from karpenter_tpu_torch.utils.resources import ResourceList


# Process-wide uid source. Production uses uuid4; the simulator installs a
# seeded random.Random so generated names/uids — and therefore event-log
# digests — are identical across runs with the same seed.
_uid_rng = None


def set_uid_source(rng) -> None:
    """Install a ``random.Random`` (or None to restore uuid4) as the uid
    source. Deterministic ids are a simulation concern only — never set
    this in a live operator."""
    global _uid_rng
    _uid_rng = rng


def new_uid() -> str:
    if _uid_rng is not None:
        return f"{_uid_rng.getrandbits(128):032x}"
    return uuid.uuid4().hex


@dataclass
class OwnerReference:
    kind: str
    name: str
    uid: str
    controller: bool = False
    block_owner_deletion: bool = False


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = "default"
    uid: str = field(default_factory=new_uid)
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    finalizers: list[str] = field(default_factory=list)
    owner_references: list[OwnerReference] = field(default_factory=list)
    creation_timestamp: float = 0.0
    deletion_timestamp: Optional[float] = None
    resource_version: int = 0
    generation: int = 1


@dataclass
class Condition:
    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    last_transition_time: float = 0.0
    observed_generation: int = 0


# -- taints / tolerations ---------------------------------------------------

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    effect: str = NO_SCHEDULE
    value: str = ""

    def match(self, other: "Taint") -> bool:
        return self.key == other.key and self.effect == other.effect


@dataclass(frozen=True)
class Toleration:
    key: str = ""
    operator: str = "Equal"  # "Equal" | "Exists"
    value: str = ""
    effect: str = ""  # empty matches all effects
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        """Mirrors corev1.Toleration.ToleratesTaint: unknown operators never
        tolerate, and Exists requires an empty value."""
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator in ("", "Equal"):
            return self.value == taint.value
        if self.operator == "Exists":
            return self.value == ""
        return False


# -- pod --------------------------------------------------------------------


@dataclass
class ContainerPort:
    container_port: int
    host_port: int = 0
    host_ip: str = ""
    protocol: str = "TCP"


@dataclass
class Container:
    name: str = "main"
    requests: ResourceList = field(default_factory=dict)
    limits: ResourceList = field(default_factory=dict)
    ports: list[ContainerPort] = field(default_factory=list)
    restart_policy: Optional[str] = None  # "Always" => sidecar init container


@dataclass
class LabelSelector:
    match_labels: dict[str, str] = field(default_factory=dict)
    # list of dicts: {"key","operator","values"}
    match_expressions: list[dict] = field(default_factory=list)

    def matches(self, labels: dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for expr in self.match_expressions:
            key, op = expr["key"], expr["operator"]
            values = expr.get("values", [])
            actual = labels.get(key)
            if op == "In":
                if actual is None or actual not in values:
                    return False
            elif op == "NotIn":
                if actual is not None and actual in values:
                    return False
            elif op == "Exists":
                if actual is None:
                    return False
            elif op == "DoesNotExist":
                if actual is not None:
                    return False
            else:
                raise ValueError(f"unknown selector operator {op}")
        return True


@dataclass
class NodeSelectorTerm:
    # list of dicts: {"key","operator","values"}
    match_expressions: list[dict] = field(default_factory=list)


@dataclass
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm


@dataclass
class NodeAffinity:
    required: list[NodeSelectorTerm] = field(default_factory=list)
    preferred: list[PreferredSchedulingTerm] = field(default_factory=list)


@dataclass
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: list[str] = field(default_factory=list)
    namespace_selector: Optional[LabelSelector] = None


@dataclass
class WeightedPodAffinityTerm:
    weight: int
    pod_affinity_term: PodAffinityTerm


@dataclass
class PodAffinity:
    required: list[PodAffinityTerm] = field(default_factory=list)
    preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class PodAntiAffinity:
    required: list[PodAffinityTerm] = field(default_factory=list)
    preferred: list[WeightedPodAffinityTerm] = field(default_factory=list)


@dataclass
class Affinity:
    node_affinity: Optional[NodeAffinity] = None
    pod_affinity: Optional[PodAffinity] = None
    pod_anti_affinity: Optional[PodAntiAffinity] = None


@dataclass
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str  # "DoNotSchedule" | "ScheduleAnyway"
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None
    node_affinity_policy: Optional[str] = None  # "Honor" | "Ignore"; None = Honor
    node_taints_policy: Optional[str] = None  # "Honor" | "Ignore"; None = Ignore
    match_label_keys: list[str] = field(default_factory=list)


@dataclass
class Volume:
    name: str = ""
    persistent_volume_claim: Optional[str] = None  # claim name
    ephemeral_storage_class: Optional[str] = None  # generic ephemeral volume


@dataclass
class PodSpec:
    node_selector: dict[str, str] = field(default_factory=dict)
    affinity: Optional[Affinity] = None
    tolerations: list[Toleration] = field(default_factory=list)
    containers: list[Container] = field(default_factory=list)
    init_containers: list[Container] = field(default_factory=list)
    topology_spread_constraints: list[TopologySpreadConstraint] = field(
        default_factory=list
    )
    volumes: list[Volume] = field(default_factory=list)
    node_name: str = ""
    scheduler_name: str = "default-scheduler"
    priority: Optional[int] = None
    priority_class_name: str = ""
    preemption_policy: str = "PreemptLowerPriority"
    overhead: ResourceList = field(default_factory=dict)
    termination_grace_period_seconds: Optional[int] = 30
    scheduling_gates: list[str] = field(default_factory=list)
    host_network: bool = False


@dataclass
class PodCondition(Condition):
    pass


@dataclass
class PodStatus:
    phase: str = "Pending"  # Pending | Running | Succeeded | Failed
    conditions: list[Condition] = field(default_factory=list)
    nominated_node_name: str = ""


@dataclass(eq=False)
class Pod:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodSpec = field(default_factory=PodSpec)
    status: PodStatus = field(default_factory=PodStatus)

    KIND = "Pod"


# -- node -------------------------------------------------------------------


@dataclass
class NodeSpec:
    provider_id: str = ""
    taints: list[Taint] = field(default_factory=list)
    unschedulable: bool = False


@dataclass
class NodeStatus:
    capacity: ResourceList = field(default_factory=dict)
    allocatable: ResourceList = field(default_factory=dict)
    conditions: list[Condition] = field(default_factory=list)
    phase: str = ""


@dataclass(eq=False)
class Node:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeSpec = field(default_factory=NodeSpec)
    status: NodeStatus = field(default_factory=NodeStatus)

    KIND = "Node"


# -- workloads / policies ---------------------------------------------------


@dataclass
class DaemonSetSpec:
    selector: LabelSelector = field(default_factory=LabelSelector)
    template_metadata: ObjectMeta = field(default_factory=ObjectMeta)
    template_spec: PodSpec = field(default_factory=PodSpec)


@dataclass(eq=False)
class DaemonSet:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: DaemonSetSpec = field(default_factory=DaemonSetSpec)

    KIND = "DaemonSet"


@dataclass
class PodDisruptionBudgetSpec:
    selector: LabelSelector = field(default_factory=LabelSelector)
    min_available: Optional[int | str] = None  # int or percentage string
    max_unavailable: Optional[int | str] = None
    unhealthy_pod_eviction_policy: Optional[str] = None  # "AlwaysAllow" | None


@dataclass
class PodDisruptionBudgetStatus:
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0


@dataclass(eq=False)
class PodDisruptionBudget:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: PodDisruptionBudgetSpec = field(default_factory=PodDisruptionBudgetSpec)
    status: PodDisruptionBudgetStatus = field(default_factory=PodDisruptionBudgetStatus)

    KIND = "PodDisruptionBudget"


# -- storage (volume topology) ---------------------------------------------


@dataclass(eq=False)
class StorageClass:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    provisioner: str = ""
    volume_binding_mode: str = "WaitForFirstConsumer"
    # NodeSelectorTerm-shaped allowed topologies
    allowed_topologies: list[NodeSelectorTerm] = field(default_factory=list)

    KIND = "StorageClass"


@dataclass(eq=False)
class PersistentVolumeClaim:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    storage_class_name: Optional[str] = None
    volume_name: str = ""  # bound PV name
    phase: str = "Pending"

    KIND = "PersistentVolumeClaim"


@dataclass(eq=False)
class PersistentVolume:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    node_affinity_required: list[NodeSelectorTerm] = field(default_factory=list)
    csi_driver: str = ""

    KIND = "PersistentVolume"


@dataclass
class CSINodeDriver:
    name: str
    allocatable_count: Optional[int] = None


@dataclass(eq=False)
class CSINode:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    drivers: list[CSINodeDriver] = field(default_factory=list)

    KIND = "CSINode"


@dataclass(eq=False)
class VolumeAttachment:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    attacher: str = ""
    node_name: str = ""
    pv_name: str = ""

    KIND = "VolumeAttachment"


@dataclass(eq=False)
class Namespace:
    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    KIND = "Namespace"


# -- helpers ----------------------------------------------------------------


def _effective_requests(container: Container) -> ResourceList:
    """Container requests with limits defaulted in for resources that set no
    request (k8s admission semantics; reference pkg/utils/resources
    MergeResourceLimitsIntoRequests)."""
    out = dict(container.requests)
    for k, v in container.limits.items():
        if k not in out:
            out[k] = v
    return out


def pod_resource_requests(pod: Pod) -> ResourceList:
    """Effective pod resource requests per the k8s pod-resource model:

    max( sum(app containers) + sum(sidecar inits),
         max_i(init_i + sum(sidecars started before init_i)) ) + overhead

    where "Always"-restart init containers are sidecars that keep running
    alongside later init containers and the app. Mirrors the accounting in
    the reference's pkg/utils/resources (Ceiling/podRequests).
    """
    sidecar_sum: ResourceList = {}
    init_ceiling: ResourceList = {}
    for c in pod.spec.init_containers:
        if c.restart_policy == "Always":
            sidecar_sum = r.merge(sidecar_sum, _effective_requests(c))
        else:
            init_ceiling = r.max_resources(
                init_ceiling, r.merge(_effective_requests(c), sidecar_sum)
            )
    main = r.merge(sidecar_sum, *(_effective_requests(c) for c in pod.spec.containers))
    out = r.max_resources(main, init_ceiling)
    if pod.spec.overhead:
        out = r.merge(out, pod.spec.overhead)
    out["pods"] = out.get("pods", 0.0) + 1.0
    return out


def pod_resource_limits(pod: Pod) -> ResourceList:
    """Effective pod resource limits under the same ceiling model as
    requests (reference pkg/utils/resources PodLimits — resources without a
    limit contribute nothing)."""
    sidecar_sum: ResourceList = {}
    init_ceiling: ResourceList = {}
    for c in pod.spec.init_containers:
        if c.restart_policy == "Always":
            sidecar_sum = r.merge(sidecar_sum, c.limits)
        else:
            init_ceiling = r.max_resources(
                init_ceiling, r.merge(c.limits, sidecar_sum)
            )
    main = r.merge(sidecar_sum, *(c.limits for c in pod.spec.containers))
    out = r.max_resources(main, init_ceiling)
    if pod.spec.overhead:
        out = r.merge(out, pod.spec.overhead)
    return out
