"""Pod binding: the framework's stand-in for kube-scheduler.

The reference never binds pods itself — its kwok E2E environment runs a real
kube-scheduler that assigns `spec.nodeName` once Karpenter's fabricated nodes
appear (test/pkg/environment/common/environment.go; binding is assumed by
kwok/cloudprovider/cloudprovider.go:58-104). This self-contained framework has
no kube-scheduler, so the BindingController closes the loop: each pass it
places unbound, active pods onto feasible registered nodes — preferring the
node whose NodeClaim the provisioner nominated for the pod — and marks pods it
cannot place as PodScheduled=False/Unschedulable, which is exactly what makes
them provisionable (utils/pod.py is_provisionable, reference
pkg/utils/pod/scheduling.go:96-107). Feasibility mirrors the kube-scheduler
predicates Karpenter models in its own simulation: taint toleration, label /
requirement compatibility, resource fit, and host-port conflicts.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Condition, Pod, pod_resource_requests
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduling.hostportusage import get_host_ports
from karpenter_tpu_torch.scheduling.volumeusage import get_volumes
from karpenter_tpu_torch.scheduling.requirements import Requirements, strict_pod_requirements
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.clock import Clock

_PODS_BOUND = global_registry.counter(
    "karpenter_pods_bound_total", "pods bound to nodes by the binding controller"
)


class BindingController:
    """Assigns pending pods to feasible ready nodes (fake kube-scheduler)."""

    def __init__(
        self,
        store: Store,
        cluster: Cluster,
        clock: Clock,
        recorder: Recorder,
        tenant: str = "",
        journal=None,
    ):
        self.store = store
        self.cluster = cluster
        self.clock = clock
        self.recorder = recorder
        self.journal = journal
        # SLO attribution: the cluster this operator serves (--cluster-name);
        # bind latencies recorded per tenant in the fleet simulation
        self.tenant = tenant
        self._last_version = -1
        self._pods_by_node: dict[str, list[Pod]] = {}

    def reconcile(self) -> int:
        """Bind every placeable unbound pod; mark the rest Unschedulable.
        Returns the number of pods bound this pass."""
        # Level-triggered short-circuit: nothing wrote to the store since the
        # last sweep, so every fit decision would come out identical.
        if self.store.resource_version == self._last_version:
            return 0
        # One pods-by-node index per sweep: the anti-affinity checks would
        # otherwise re-scan the whole Pod collection per candidate node.
        self._pods_by_node: dict[str, list[Pod]] = {}
        # Terminal (Succeeded/Failed) pods don't repel candidates:
        # kube-scheduler ignores them for inter-pod (anti-)affinity.
        for p in self.store.list(
            "Pod",
            predicate=lambda p: p.spec.node_name != "" and podutil.is_active(p),
        ):
            self._pods_by_node.setdefault(p.spec.node_name, []).append(p)
        bound = 0
        for pod in self.store.list("Pod", predicate=self._needs_binding):
            node = self._find_fit(pod)
            if node is not None:
                self._bind(pod, node)
                bound += 1
            else:
                self._mark_unschedulable(pod)
        self._last_version = self.store.resource_version
        return bound

    def _needs_binding(self, pod: Pod) -> bool:
        return (
            podutil.is_active(pod)
            and not podutil.is_scheduled(pod)
            and not podutil.is_owned_by_daemon_set(pod)
            and not podutil.is_owned_by_node(pod)
        )

    # -- placement ----------------------------------------------------------

    def _find_fit(self, pod: Pod) -> StateNode | None:
        key = (pod.metadata.namespace, pod.metadata.name)
        nominated_claim = self.cluster.pod_node_claim_mapping(key)
        candidates: list[tuple[int, StateNode]] = []
        for sn in self.cluster.nodes.values():
            if not self._feasible(pod, sn):
                continue
            # Prefer the provisioner's nomination, then already-nominated
            # nodes, so binds track scheduling decisions instead of racing
            # them (mirrors kube-scheduler honoring nominatedNodeName).
            if (
                sn.node_claim is not None
                and sn.node_claim.metadata.name == nominated_claim
            ):
                rank = 0
            elif sn.nominated(self.clock.now()):
                rank = 1
            else:
                rank = 2
            candidates.append((rank, sn))
        if not candidates:
            return None
        candidates.sort(key=lambda t: (t[0], t[1].name()))
        return candidates[0][1]

    def _feasible(self, pod: Pod, sn: StateNode) -> bool:
        if sn.node is None or not sn.registered():
            return False
        if sn.is_marked_for_deletion() or sn.node.metadata.deletion_timestamp is not None:
            return False
        # kube-scheduler only hard-blocks on NoSchedule/NoExecute;
        # PreferNoSchedule is a scoring preference and never prevents a bind
        # (Karpenter's own simulation soft-blocks it until the relax ladder
        # tolerates — the binding stand-in must not copy that strictness)
        hard = Taints(
            t for t in sn.taints() if t.effect in ("NoSchedule", "NoExecute")
        )
        if hard.tolerates_pod(pod) is not None:
            return False
        node_reqs = Requirements.from_labels(sn.labels())
        if node_reqs.compatible(strict_pod_requirements(pod)) is not None:
            return False
        if not res.fits(pod_resource_requests(pod), sn.available()):
            return False
        if sn.hostport_usage.conflicts(pod, get_host_ports(pod)) is not None:
            return False
        if sn.volume_usage.exceeds_limits(get_volumes(self.store, pod)) is not None:
            return False
        if not self._anti_affinity_ok(pod, sn):
            return False
        return True

    def _anti_affinity_ok(self, pod: Pod, sn: StateNode) -> bool:
        """Required pod anti-affinity, both directions (the kube-scheduler
        predicates the provisioner's simulation also enforces,
        scheduler/topology.py inverse tracking)."""
        node_labels = sn.labels()
        # Forward: the candidate pod's own terms — no already-placed pod in
        # the term's topology domain may match the selector.
        for term in self._required_anti_affinity_terms(pod):
            domain = node_labels.get(term.topology_key)
            if domain is None:
                continue
            for other in self.cluster.nodes.values():
                if other.node is None or other.labels().get(term.topology_key) != domain:
                    continue
                for placed in self._pods_by_node.get(other.node.metadata.name, ()):
                    if self._term_matches(term, pod.metadata.namespace, placed):
                        return False
        # Inverse: already-placed pods with required anti-affinity must not
        # match the candidate pod within their domain.
        ok = True

        def check(placed: Pod, placed_node) -> bool:
            nonlocal ok
            for term in self._required_anti_affinity_terms(placed):
                if placed_node.metadata.labels.get(term.topology_key) != node_labels.get(
                    term.topology_key
                ):
                    continue
                if node_labels.get(term.topology_key) is None:
                    continue
                if self._term_matches(term, placed.metadata.namespace, pod):
                    ok = False
                    return False
            return True

        self.cluster.for_pods_with_anti_affinity(check)
        return ok

    @staticmethod
    def _required_anti_affinity_terms(pod: Pod):
        aff = pod.spec.affinity
        if aff is None or aff.pod_anti_affinity is None:
            return []
        return aff.pod_anti_affinity.required

    @staticmethod
    def _term_matches(term, term_namespace: str, candidate: Pod) -> bool:
        namespaces = term.namespaces or [term_namespace]
        if candidate.metadata.namespace not in namespaces:
            return False
        if term.label_selector is None:
            return False
        return term.label_selector.matches(candidate.metadata.labels)

    # -- mutations ----------------------------------------------------------

    def _bind(self, pod: Pod, sn: StateNode) -> None:
        seq = None
        if self.journal is not None:
            seq = self.journal.intent(
                "pod.bind",
                uid=pod.metadata.uid,
                key=f"bind/{pod.metadata.uid}",
                pod=pod.metadata.name,
                node=sn.node.metadata.name,
            )
        pod.spec.node_name = sn.node.metadata.name
        pod.status.phase = "Running"
        pod.status.conditions = [
            c for c in pod.status.conditions if c.type != podutil.POD_SCHEDULED
        ]
        pod.status.conditions.append(
            Condition(type=podutil.POD_SCHEDULED, status="True", reason="Bound")
        )
        self.store.update(pod)
        if seq is not None:
            self.journal.done(seq)
        # Keep the live mirror current within this pass so subsequent binds
        # in the same sweep see the node's reduced headroom.
        self.cluster.update_pod(pod)
        self._pods_by_node.setdefault(pod.spec.node_name, []).append(pod)
        _PODS_BOUND.inc()
        # SLO feed: time-to-bind in virtual time (creation stamp comes from
        # the injected Clock via the store), classified by the objective's
        # threshold — the pod-bind-latency burn-rate series
        from karpenter_tpu_torch.observability import slo

        created = pod.metadata.creation_timestamp or self.clock.now()
        slo.engine().observe(
            "pod-bind-latency",
            max(0.0, self.clock.now() - created),
            tenant=self.tenant,
        )
        # final journey hop: re-join the pod's scheduling trace (linked at
        # pod.schedule) — or the claim's, for pods the provisioner never
        # named (e.g. daemonset-shaped arrivals onto a fresh node). A pod
        # bound straight to pre-existing capacity roots a trivial trace.
        tracer = tracing.tracer()
        claim_name = (
            sn.node_claim.metadata.name if sn.node_claim is not None else ""
        )
        ctx = tracer.linked("pod", pod.metadata.uid)
        if ctx is None and claim_name:
            ctx = tracer.linked("nodeclaim", claim_name)
        tracer.event(
            "pod.bind",
            parent=ctx,
            pod=pod.metadata.name,
            pod_uid=pod.metadata.uid,
            node=sn.node.metadata.name,
            nodeclaim=claim_name,
        )
        self.recorder.publish(
            Event(pod, "Normal", "Scheduled", f"bound to {sn.node.metadata.name}")
        )

    def _mark_unschedulable(self, pod: Pod) -> None:
        if podutil.failed_to_schedule(pod):
            return
        pod.status.conditions = [
            c for c in pod.status.conditions if c.type != podutil.POD_SCHEDULED
        ]
        pod.status.conditions.append(
            Condition(
                type=podutil.POD_SCHEDULED,
                status="False",
                reason=podutil.REASON_UNSCHEDULABLE,
            )
        )
        self.store.update(pod)
