"""NodeClaim auxiliary controllers: expiration, garbage collection,
consistency, pod events, hydration.

Mirrors nodeclaim/expiration/controller.go:49-107,
nodeclaim/garbagecollection/controller.go:51-124,
nodeclaim/consistency/controller.go:66-161,
nodeclaim/podevents/controller.go:54-120, nodeclaim/hydration/.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import (
    CONDITION_CONSISTENT_STATE_FOUND,
    CONDITION_INITIALIZED,
    CONDITION_LAUNCHED,
    CONDITION_REGISTERED,
    NodeClaim,
)
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, NodeClaimNotFoundError
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator.harness import RECONCILE_ERRORS
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock

_log = klog.logger("nodeclaim.garbagecollection")

GC_PERIOD = 120.0  # garbagecollection/controller.go: every 2m
# podevents dedupes rapid event storms to one status write per 10s window
POD_EVENT_DEDUPE = 10.0

_EXPIRED_TOTAL = global_registry.counter(
    "karpenter_nodeclaims_disrupted_total",
    "nodeclaims disrupted",
    labels=["reason", "nodepool", "capacity_type"],
)


class ExpirationController:
    """Force-delete claims older than spec.expireAfter
    (expiration/controller.go:49-107)."""

    def __init__(self, store: Store, clock: Clock, recorder: Recorder):
        self.store = store
        self.clock = clock
        self.recorder = recorder

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            return
        expire_after = claim.spec.expire_after
        if expire_after is None:
            return
        age = self.clock.since(claim.metadata.creation_timestamp)
        if age < expire_after:
            return
        _EXPIRED_TOTAL.inc(
            {
                "reason": "expired",
                "nodepool": claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                "capacity_type": claim.metadata.labels.get(
                    wk.CAPACITY_TYPE_LABEL_KEY, ""
                ),
            }
        )
        self.recorder.publish(
            Event(claim, "Normal", "Expired", f"NodeClaim expired after {expire_after}s")
        )
        self.store.delete(claim)


_GC_DELETE_ERRORS = global_registry.counter(
    "karpenter_nodeclaims_gc_delete_errors_total",
    "orphaned cloud instances whose deletion failed during garbage collection",
)


class GarbageCollectionController:
    """Reconcile cloud instances vs claims both ways
    (garbagecollection/controller.go:51-124). Orphan-delete failures are
    never silent: the reference logs each one and relies on the 2m
    requeue to retry (garbagecollection/controller.go:93-116) — here each
    failure logs, counts, and emits a Warning event so a persistently
    undeletable instance (= invisible cost leakage) shows up."""

    def __init__(
        self,
        store: Store,
        cloud_provider: CloudProvider,
        clock: Clock,
        recorder: Recorder | None = None,
    ):
        self.store = store
        self.cloud_provider = cloud_provider
        self.clock = clock
        self.recorder = recorder
        self._last_run = -GC_PERIOD

    def expedite(self) -> None:
        """Make the next reconcile sweep immediately instead of waiting out
        GC_PERIOD — recovery calls this after marking orphans so instances
        acknowledged by the cloud but owned by no claim are reaped on the
        first post-recovery pass."""
        self._last_run = self.clock.now() - GC_PERIOD

    def reconcile(self) -> None:
        if self.clock.now() - self._last_run < GC_PERIOD:
            return
        self._last_run = self.clock.now()
        cloud_claims = {c.status.provider_id: c for c in self.cloud_provider.list()}
        store_claims = self.store.list("NodeClaim")
        store_pids = {
            c.status.provider_id for c in store_claims if c.status.provider_id
        }
        # Orphaned cloud instances: launched, no claim remembers them
        for pid, cloud_claim in cloud_claims.items():
            if pid not in store_pids:
                try:
                    self.cloud_provider.delete(cloud_claim)
                except NodeClaimNotFoundError:
                    pass  # terminated out-of-band between list() and delete()
                except Exception as e:  # noqa: BLE001 — retried next GC period
                    _GC_DELETE_ERRORS.inc()
                    # per-claim failures must not abort the sweep, so they
                    # can't propagate to the harness — count them into the
                    # shared reconcile-error metric here so GC retries are
                    # observable alongside every other controller's errors
                    RECONCILE_ERRORS.inc(
                        {"controller": "nodeclaim.garbagecollection"}
                    )
                    _log.error(
                        "failed to garbage-collect orphaned instance",
                        provider_id=pid,
                        error=str(e),
                    )
                    if self.recorder is not None:
                        self.recorder.publish(
                            Event(
                                cloud_claim,
                                "Warning",
                                "FailedGarbageCollection",
                                f"deleting orphaned instance {pid}: {e}",
                            )
                        )
        # Claims whose instance disappeared underneath them
        for claim in store_claims:
            if (
                claim.condition_is_true(CONDITION_LAUNCHED)
                and claim.status.provider_id
                and claim.status.provider_id not in cloud_claims
                and claim.metadata.deletion_timestamp is None
            ):
                self.store.delete(claim)


class ConsistencyController:
    """Invariant checks between claim and node shape
    (consistency/controller.go:66-161)."""

    def __init__(self, store: Store, recorder: Recorder, clock: Clock):
        self.store = store
        self.recorder = recorder
        self.clock = clock

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            return
        if not claim.condition_is_true(CONDITION_REGISTERED):
            return
        node = next(
            iter(
                self.store.list(
                    "Node",
                    predicate=lambda n: n.spec.provider_id == claim.status.provider_id,
                )
            ),
            None,
        )
        if node is None:
            return
        failures = []
        # node shape must cover what the claim promised
        for name, quantity in claim.status.allocatable.items():
            if quantity > 0 and node.status.allocatable.get(name, 0.0) <= 0:
                failures.append(f"expected resource {name!r} not found on node")
        if claim.condition_is_true(CONDITION_INITIALIZED):
            # NodeShape (consistency/nodeshape.go:35-59): for every requested
            # resource, the registered node must carry ≥90% of the capacity
            # the claim promised
            requests = claim.spec.resources.requests
            for name, requested in requests.items():
                expected = claim.status.capacity.get(name, 0.0)
                if requested <= 0 or expected <= 0:
                    continue
                found = node.status.capacity.get(name, 0.0)
                pct = found / expected
                if pct < 0.90:
                    failures.append(
                        f"expected {expected} of resource {name}, but found "
                        f"{found} ({pct * 100:.1f}% of expected)"
                    )
            # claim-required taints must not be missing post-startup
            node_taints = {(t.key, t.effect) for t in node.spec.taints}
            for t in claim.spec.taints:
                if (t.key, t.effect) not in node_taints:
                    failures.append(f"expected taint {t.key}:{t.effect} not found")
        if failures:
            claim.set_condition(
                CONDITION_CONSISTENT_STATE_FOUND,
                "False",
                reason="ConsistencyCheckFailed",
                message="; ".join(failures),
                now=self.clock.now(),
            )
            self.recorder.publish(
                Event(claim, "Warning", "FailedConsistencyCheck", "; ".join(failures))
            )
        else:
            claim.set_condition(
                CONDITION_CONSISTENT_STATE_FOUND, "True", now=self.clock.now()
            )
        self.store.apply(claim)


class PodEventsController:
    """Stamp lastPodEventTime on pod schedule/terminate so consolidateAfter
    counts from real pod activity (podevents/controller.go:54-120)."""

    def __init__(self, store: Store, clock: Clock):
        self.store = store
        self.clock = clock

    def on_pod_event(self, pod) -> None:
        if not pod.spec.node_name:
            return
        node = self.store.try_get("Node", pod.spec.node_name)
        if node is None:
            return
        claim = next(
            iter(
                self.store.list(
                    "NodeClaim",
                    predicate=lambda c: c.status.provider_id == node.spec.provider_id,
                )
            ),
            None,
        )
        if claim is None:
            return
        now = self.clock.now()
        if now - claim.status.last_pod_event_time < POD_EVENT_DEDUPE:
            return
        claim.status.last_pod_event_time = now
        self.store.apply(claim)


class HydrationController:
    """Backfill newly-introduced metadata onto pre-existing claims/nodes
    after an upgrade (nodeclaim/hydration, node/hydration)."""

    def __init__(self, store: Store):
        self.store = store

    def reconcile_claim(self, claim: NodeClaim) -> None:
        ref = claim.spec.node_class_ref
        if not ref.kind:
            return
        from karpenter_tpu_torch.scheduler.nodeclaimtemplate import node_class_label_key

        key = node_class_label_key(ref.group, ref.kind)
        if key not in claim.metadata.labels:
            claim.metadata.labels[key] = ref.name
            self.store.apply(claim)

    def reconcile_node(self, node) -> None:
        claim = next(
            iter(
                self.store.list(
                    "NodeClaim",
                    predicate=lambda c: c.status.provider_id == node.spec.provider_id,
                )
            ),
            None,
        )
        if claim is None or not claim.spec.node_class_ref.kind:
            return
        from karpenter_tpu_torch.scheduler.nodeclaimtemplate import node_class_label_key

        ref = claim.spec.node_class_ref
        key = node_class_label_key(ref.group, ref.kind)
        if key not in node.metadata.labels:
            node.metadata.labels[key] = ref.name
            self.store.apply(node)
