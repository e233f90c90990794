"""Preference relaxation ladder.

Mirrors the reference's scheduling/preferences.go:33-145: when a pod fails to
schedule, soft constraints are removed one at a time, in a fixed order, until
it fits or nothing is left to relax. Order matters for decision parity:
required node-affinity OR-term → preferred pod-affinity → preferred pod
anti-affinity → preferred node-affinity → ScheduleAnyway spread →
(optionally) tolerate PreferNoSchedule taints.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis.core import PREFER_NO_SCHEDULE, Pod, Toleration


class Preferences:
    def __init__(self, tolerate_prefer_no_schedule: bool = False):
        self.tolerate_prefer_no_schedule = tolerate_prefer_no_schedule

    def relax(self, pod: Pod) -> bool:
        """Mutates the pod, removing one soft constraint. True if relaxed."""
        # the device fast path and topology engine cache spec-shape
        # signatures on the object; any in-place spec mutation must
        # invalidate them (ops/ffd._raw_sig, ops/ffd_topo._topo_sig,
        # scheduler/topology._pod_shape_key). The topology COUNT state is
        # deliberately untouched: ladder retries re-enter the solver with
        # the same TopologyGroup objects, so the device count tensors keyed
        # on them stay warm across rungs — only the relaxed pod's shape
        # identity is recomputed.
        if hasattr(pod, "_kt_sig"):
            del pod._kt_sig
        if hasattr(pod, "_kt_tsig"):
            del pod._kt_tsig
        if hasattr(pod, "_kt_topo_key"):
            del pod._kt_topo_key
        relaxations = [
            self.remove_required_node_affinity_term,
            self.remove_preferred_pod_affinity_term,
            self.remove_preferred_pod_anti_affinity_term,
            self.remove_preferred_node_affinity_term,
            self.remove_topology_spread_schedule_anyway,
        ]
        if self.tolerate_prefer_no_schedule:
            relaxations.append(self.tolerate_prefer_no_schedule_taints)
        for relax in relaxations:
            if relax(pod) is not None:
                return True
        return False

    def remove_required_node_affinity_term(self, pod: Pod) -> Optional[str]:
        """Drop the first OR term when more than one exists — only daemons
        reach single-term removal via isDaemonPodCompatible
        (preferences.go:70-83)."""
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or not aff.node_affinity.required:
            return None
        terms = aff.node_affinity.required
        if len(terms) > 1:
            aff.node_affinity.required = terms[1:]
            return "removed required node affinity term[0]"
        return None

    def remove_preferred_node_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.node_affinity is None or not aff.node_affinity.preferred:
            return None
        terms = sorted(aff.node_affinity.preferred, key=lambda t: -t.weight)
        aff.node_affinity.preferred = terms[1:]
        return "removed heaviest preferred node affinity term"

    def remove_preferred_pod_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.pod_affinity is None or not aff.pod_affinity.preferred:
            return None
        terms = sorted(aff.pod_affinity.preferred, key=lambda t: -t.weight)
        aff.pod_affinity.preferred = terms[1:]
        return "removed heaviest preferred pod affinity term"

    def remove_preferred_pod_anti_affinity_term(self, pod: Pod) -> Optional[str]:
        aff = pod.spec.affinity
        if aff is None or aff.pod_anti_affinity is None or not aff.pod_anti_affinity.preferred:
            return None
        terms = sorted(aff.pod_anti_affinity.preferred, key=lambda t: -t.weight)
        aff.pod_anti_affinity.preferred = terms[1:]
        return "removed heaviest preferred pod anti-affinity term"

    def remove_topology_spread_schedule_anyway(self, pod: Pod) -> Optional[str]:
        for i, tsc in enumerate(pod.spec.topology_spread_constraints):
            if tsc.when_unsatisfiable == "ScheduleAnyway":
                constraints = pod.spec.topology_spread_constraints
                constraints[i] = constraints[-1]
                pod.spec.topology_spread_constraints = constraints[:-1]
                return "removed ScheduleAnyway topology spread constraint"
        return None

    def tolerate_prefer_no_schedule_taints(self, pod: Pod) -> Optional[str]:
        wildcard = Toleration(operator="Exists", effect=PREFER_NO_SCHEDULE)
        for t in pod.spec.tolerations:
            if (
                t.operator == wildcard.operator
                and t.effect == wildcard.effect
                and t.key == ""
                and t.value == ""
            ):
                return None
        pod.spec.tolerations = list(pod.spec.tolerations) + [wildcard]
        return "added toleration for PreferNoSchedule taints"
