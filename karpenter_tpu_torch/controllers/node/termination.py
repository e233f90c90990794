"""Node termination: finalizer pipeline taint → drain → volume detachment →
instance termination, with TGP enforcement.

Mirrors the reference's node/termination/controller.go:85-160 and
termination/terminator/{terminator,eviction}.go.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Node, Pod
from karpenter_tpu_torch.apis.nodeclaim import (
    CONDITION_DRAINED,
    CONDITION_INSTANCE_TERMINATING,
    CONDITION_VOLUMES_DETACHED,
    NodeClaim,
)
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, NodeClaimNotFoundError
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduling.taints import DISRUPTED_NO_SCHEDULE_TAINT
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.pdb import Limits

_NODES_TERMINATED = global_registry.counter(
    "karpenter_nodes_terminated_total", "nodes terminated", labels=["nodepool"]
)
_TERMINATION_DURATION = global_registry.histogram(
    "karpenter_nodes_termination_duration_seconds",
    "time from deletion to finalizer removal",
)
_NODES_DRAINED = global_registry.counter(
    "karpenter_nodes_drained_total",
    "nodes drained by karpenter",
    labels=["nodepool"],
)
_NODE_LIFETIME = global_registry.histogram(
    "karpenter_nodes_lifetime_duration_seconds",
    "node lifetime since creation",
    labels=["nodepool"],
    buckets=(
        300.0, 600.0, 1800.0, 3600.0, 21600.0, 43200.0, 86400.0,
        172800.0, 604800.0, 2592000.0,
    ),
)

SYSTEM_CRITICAL_PRIORITY = 2_000_000_000  # system-cluster-critical floor


class EvictionQueue:
    """Eviction API stand-in: evicts when PDBs allow; 429-style requeue when
    they don't (terminator/eviction.go:154-216)."""

    def __init__(self, store: Store, recorder: Recorder, clock: Clock):
        self.store = store
        self.recorder = recorder
        self.clock = clock
        self._pending: dict[tuple[str, str], Pod] = {}

    def add(self, *pods: Pod) -> None:
        for p in pods:
            self._pending.setdefault((p.metadata.namespace, p.metadata.name), p)

    def reconcile(self) -> None:
        pdbs = Limits.from_pdbs(self.store.list("PodDisruptionBudget"))
        for key, pod in list(self._pending.items()):
            live = self.store.try_get("Pod", key[1], key[0])
            if live is None or podutil.is_terminal(live):
                del self._pending[key]
                continue
            _, ok = pdbs.can_evict_pods([live])
            if not ok:
                continue  # 429: retry next pass
            self.recorder.publish(Event(live, "Normal", "Evicted", "Evicted pod"))
            self.store.delete(live)
            del self._pending[key]

    def has(self, pod: Pod) -> bool:
        return (pod.metadata.namespace, pod.metadata.name) in self._pending


class Terminator:
    """Drain logic (terminator/terminator.go:55-166)."""

    def __init__(self, clock: Clock, store: Store, queue: EvictionQueue, recorder: Recorder):
        self.clock = clock
        self.store = store
        self.queue = queue
        self.recorder = recorder

    # kubernetes well-known label: service controllers drop labeled nodes
    # from load-balancer target groups (terminator.go:67-74 — applied
    # before draining so connections drain ahead of instance termination)
    EXCLUDE_BALANCERS_LABEL = "node.kubernetes.io/exclude-from-external-load-balancers"

    def taint(self, node: Node) -> None:
        changed = False
        if not any(t.match(DISRUPTED_NO_SCHEDULE_TAINT) for t in node.spec.taints):
            node.spec.taints = list(node.spec.taints) + [DISRUPTED_NO_SCHEDULE_TAINT]
            changed = True
        if node.metadata.labels.get(self.EXCLUDE_BALANCERS_LABEL) != "karpenter":
            node.metadata.labels[self.EXCLUDE_BALANCERS_LABEL] = "karpenter"
            changed = True
        if changed:
            self.store.apply(node)

    def drain(self, node: Node, grace_expiration: Optional[float]) -> Optional[str]:
        """Evict pods in groups, critical last; None when drained
        (terminator.go:96-138)."""
        pods = self.store.pods_on_node(node.metadata.name)
        # TGP enforcement: pods whose own grace period overruns the node
        # deadline are force-deleted (terminator.go:140-166)
        if grace_expiration is not None:
            for p in pods:
                grace = float(p.spec.termination_grace_period_seconds or 30)
                if (
                    p.metadata.deletion_timestamp is None
                    and self.clock.now() + grace > grace_expiration
                ):
                    self.recorder.publish(
                        Event(
                            p, "Warning", "ForcedEviction",
                            "Pod deleted to honor node termination grace period",
                        )
                    )
                    self.store.delete(p)
            pods = self.store.pods_on_node(node.metadata.name)
        drainable = [p for p in pods if podutil.is_waiting_eviction(p, self.clock)]
        evictable = [p for p in drainable if podutil.is_evictable(p)]
        # group: non-critical first, critical (priority >= 2e9 or node-critical
        # priority class) last — keep infrastructure up while apps leave
        non_critical = [p for p in evictable if not _is_critical(p)]
        critical = [p for p in evictable if _is_critical(p)]
        for group in (non_critical, critical):
            active = [p for p in group if p.metadata.deletion_timestamp is None]
            if active:
                self.queue.add(*active)
                return f"waiting on eviction of {len(active)} pod(s)"
        if drainable:
            return f"waiting on {len(drainable)} pod(s) to terminate"
        return None


def _is_critical(pod: Pod) -> bool:
    if pod.spec.priority is not None and pod.spec.priority >= SYSTEM_CRITICAL_PRIORITY:
        return True
    return pod.spec.priority_class_name in (
        "system-cluster-critical",
        "system-node-critical",
    )


class TerminationController:
    """The Node finalizer pipeline (termination/controller.go:85-160)."""

    def __init__(
        self,
        store: Store,
        cloud_provider: CloudProvider,
        terminator: Terminator,
        recorder: Recorder,
        clock: Clock,
    ):
        self.store = store
        self.cloud_provider = cloud_provider
        self.terminator = terminator
        self.recorder = recorder
        self.clock = clock

    def reconcile(self, node: Node) -> None:
        if node.metadata.deletion_timestamp is None:
            return
        if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
            return
        claim = self._claim_for(node)
        # If the underlying instance no longer exists AND the kubelet is not
        # reporting Ready, skip the graceful drain — pods can't run anyway
        # (termination/controller.go:109-120). A Ready node means the kubelet
        # process still lives despite the provider's answer, so drain anyway.
        ready = next(
            (c.status for c in node.status.conditions if c.type == "Ready"), ""
        )
        if ready != "True":
            try:
                self.cloud_provider.get(node.spec.provider_id)
            except NodeClaimNotFoundError:
                self._finalize(node)
                return
        self.terminator.taint(node)
        grace_expiration = self._grace_expiration(claim)

        not_drained = self.terminator.drain(node, grace_expiration)
        if not_drained:
            if claim is not None:
                claim.set_condition(
                    CONDITION_DRAINED, "False", reason="Draining",
                    message=not_drained, now=self.clock.now(),
                )
                self.store.apply(claim)
            return
        if claim is not None and not claim.condition_is_true(CONDITION_DRAINED):
            claim.set_condition(CONDITION_DRAINED, "True", now=self.clock.now())
            self.store.apply(claim)
            # increment only on the False->True transition, claim present —
            # the reference's double-count guard (controller.go:160-166)
            _NODES_DRAINED.inc(
                {"nodepool": node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")}
            )

        # volumes: all VolumeAttachments for drainable volumes must detach
        attachments = self._blocking_volume_attachments(node)
        if attachments and (
            grace_expiration is None or self.clock.now() < grace_expiration
        ):
            if claim is not None:
                claim.set_condition(
                    CONDITION_VOLUMES_DETACHED, "False", reason="AwaitingDetachment",
                    message=f"{len(attachments)} volume attachment(s) remain",
                    now=self.clock.now(),
                )
                self.store.apply(claim)
            return
        if claim is not None and not claim.condition_is_true(CONDITION_VOLUMES_DETACHED):
            claim.set_condition(CONDITION_VOLUMES_DETACHED, "True", now=self.clock.now())
            self.store.apply(claim)

        # instance termination
        if claim is not None:
            try:
                self.cloud_provider.delete(claim)
                claim.set_condition(
                    CONDITION_INSTANCE_TERMINATING, "True", now=self.clock.now()
                )
                self.store.apply(claim)
                return  # wait for the instance to actually go away
            except NodeClaimNotFoundError:
                pass
        self._finalize(node)

    def _blocking_volume_attachments(self, node: Node) -> list:
        """VolumeAttachments that should block termination: attachments
        whose volumes belong to UNDRAINABLE pods are excluded — those pods
        stay on the node, so their volumes will never detach
        (termination/controller.go:303-345 filterVolumeAttachments)."""
        attachments = self.store.list(
            "VolumeAttachment",
            predicate=lambda va: va.node_name == node.metadata.name,
        )
        if not attachments:
            return attachments
        undrainable_pvs: set[str] = set()
        for pod in self.store.pods_on_node(node.metadata.name):
            if podutil.is_drainable(pod, self.clock):
                continue
            for vol in pod.spec.volumes:
                claim_name = vol.persistent_volume_claim
                if claim_name is None and vol.ephemeral_storage_class is not None:
                    # generic ephemeral volume: PVC named <pod>-<volume>
                    # (volumeusage.py get_volumes uses the same convention)
                    claim_name = f"{pod.metadata.name}-{vol.name}"
                if not claim_name:
                    continue
                pvc = self.store.try_get(
                    "PersistentVolumeClaim",
                    claim_name,
                    namespace=pod.metadata.namespace,
                )
                if pvc is not None and pvc.volume_name:
                    undrainable_pvs.add(pvc.volume_name)
        # attachments with no named PV can't be matched to a pod and are
        # not waited on, per the reference's PersistentVolumeName filter
        return [
            va
            for va in attachments
            if va.pv_name and va.pv_name not in undrainable_pvs
        ]

    def _finalize(self, node: Node) -> None:
        """Counter + duration/lifetime histograms + finalizer removal —
        shared by the drained path and the instance-gone fast path so the
        metrics never drift apart."""
        pool = {"nodepool": node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")}
        _NODES_TERMINATED.inc(pool)
        _TERMINATION_DURATION.observe(
            self.clock.now() - (node.metadata.deletion_timestamp or self.clock.now())
        )
        _NODE_LIFETIME.observe(
            self.clock.now() - node.metadata.creation_timestamp, pool
        )
        self.store.remove_finalizer(node, wk.TERMINATION_FINALIZER)

    def _claim_for(self, node: Node) -> Optional[NodeClaim]:
        from karpenter_tpu_torch.utils.node import claim_for_node

        return claim_for_node(self.store, node)

    def _grace_expiration(self, claim: Optional[NodeClaim]) -> Optional[float]:
        if claim is None:
            return None
        raw = claim.metadata.annotations.get(
            wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
        )
        if raw is None:
            return None
        try:
            return float(raw)
        except ValueError:
            return None
