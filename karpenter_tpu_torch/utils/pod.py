"""Pod classification predicates.

Mirrors the reference's pkg/utils/pod/scheduling.go:33-216 — which pods are
provisionable (need new capacity), reschedulable (count when simulating),
evictable/drainable (termination flow).
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT, Taints
from karpenter_tpu_torch.utils.clock import Clock

# Buffer past terminationGracePeriod before a terminating pod is considered
# stuck (scheduling.go:150-156).
STUCK_TERMINATING_BUFFER = 60.0

POD_SCHEDULED = "PodScheduled"
REASON_UNSCHEDULABLE = "Unschedulable"


def is_terminal(pod: Pod) -> bool:
    return pod.status.phase in ("Failed", "Succeeded")


def is_terminating(pod: Pod) -> bool:
    return pod.metadata.deletion_timestamp is not None


def is_active(pod: Pod) -> bool:
    return not is_terminal(pod) and not is_terminating(pod)


def is_stuck_terminating(pod: Pod, clock: Clock) -> bool:
    return (
        is_terminating(pod)
        and clock.since(pod.metadata.deletion_timestamp) > STUCK_TERMINATING_BUFFER
    )


def is_owned_by(pod: Pod, kinds: tuple[str, ...]) -> bool:
    return any(ref.kind in kinds for ref in pod.metadata.owner_references)


def is_owned_by_stateful_set(pod: Pod) -> bool:
    return is_owned_by(pod, ("StatefulSet",))


def is_owned_by_daemon_set(pod: Pod) -> bool:
    return is_owned_by(pod, ("DaemonSet",))


def is_owned_by_node(pod: Pod) -> bool:
    """Static/mirror pods — unmanageable via the API server."""
    return is_owned_by(pod, ("Node",))


def has_do_not_disrupt(pod: Pod) -> bool:
    return pod.metadata.annotations.get(wk.DO_NOT_DISRUPT_ANNOTATION_KEY) == "true"


def tolerates_disrupted_no_schedule_taint(pod: Pod) -> bool:
    return Taints([DISRUPTED_NO_SCHEDULE_TAINT]).tolerates_pod(pod) is None


def failed_to_schedule(pod: Pod) -> bool:
    """kube-scheduler marked the pod PodScheduled=Unschedulable
    (scheduling.go:121-129)."""
    return any(
        c.type == POD_SCHEDULED and c.reason == REASON_UNSCHEDULABLE
        for c in pod.status.conditions
    )


def is_scheduled(pod: Pod) -> bool:
    return pod.spec.node_name != ""


def is_preempting(pod: Pod) -> bool:
    return pod.status.nominated_node_name != ""


def is_provisionable(pod: Pod) -> bool:
    """Pod needs new capacity (scheduling.go:96-107)."""
    return (
        failed_to_schedule(pod)
        and not is_scheduled(pod)
        and not is_preempting(pod)
        and not is_owned_by_daemon_set(pod)
        and not is_owned_by_node(pod)
    )


def is_reschedulable(pod: Pod) -> bool:
    """Pod counts when simulating rescheduling to new capacity
    (scheduling.go:38-48). Terminating StatefulSet pods count: the old pod
    must go before its replacement exists, so capacity is still needed."""
    return (
        (is_active(pod) or (is_owned_by_stateful_set(pod) and is_terminating(pod)))
        and not is_owned_by_daemon_set(pod)
        and not is_owned_by_node(pod)
    )


def is_evictable(pod: Pod) -> bool:
    """Karpenter will call the eviction API for this pod (scheduling.go:50-61)."""
    return (
        is_active(pod)
        and not tolerates_disrupted_no_schedule_taint(pod)
        and not is_owned_by_node(pod)
        and not has_do_not_disrupt(pod)
    )


def is_drainable(pod: Pod, clock: Clock) -> bool:
    """Node drain must wait for this pod (scheduling.go:72-85). do-not-disrupt
    pods ARE drainable — drain stalls on them even though we don't evict."""
    return (
        not tolerates_disrupted_no_schedule_taint(pod)
        and not is_stuck_terminating(pod, clock)
        and not is_owned_by_node(pod)
    )


def is_waiting_eviction(pod: Pod, clock: Clock) -> bool:
    return not is_terminal(pod) and is_drainable(pod, clock)


def is_disruptable(pod: Pod) -> bool:
    return not (is_active(pod) and has_do_not_disrupt(pod))


def is_eligible_for_forced_eviction(pod: Pod, node_grace_expiration: float | None) -> bool:
    """Pod's own grace period would overrun the node's TGP deadline
    (scheduling.go:87-94)."""
    return (
        node_grace_expiration is not None
        and is_terminating(pod)
        and pod.metadata.deletion_timestamp > node_grace_expiration
    )


def has_required_pod_anti_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return (
        aff is not None
        and aff.pod_anti_affinity is not None
        and len(aff.pod_anti_affinity.required) > 0
    )


def has_pod_anti_affinity(pod: Pod) -> bool:
    aff = pod.spec.affinity
    return aff is not None and aff.pod_anti_affinity is not None and (
        len(aff.pod_anti_affinity.required) > 0
        or len(aff.pod_anti_affinity.preferred) > 0
    )
