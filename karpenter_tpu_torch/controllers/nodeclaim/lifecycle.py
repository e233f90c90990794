"""NodeClaim lifecycle: Launch → Registration → Initialization → Liveness,
plus finalizer-based termination.

Mirrors the reference's nodeclaim/lifecycle/{controller,launch,registration,
initialization,liveness}.go.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Node
from karpenter_tpu_torch.apis.nodeclaim import (
    CONDITION_INITIALIZED,
    CONDITION_INSTANCE_TERMINATING,
    CONDITION_LAUNCHED,
    CONDITION_REGISTERED,
    NodeClaim,
)
from karpenter_tpu_torch.apis.nodepool import CONDITION_NODE_REGISTRATION_HEALTHY
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    CreateError,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
)
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.journal import IDEMPOTENCY_ANNOTATION, Journal
from karpenter_tpu_torch.runtime.store import NotFound as StoreNotFound
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduling.requirements import requirements_from_dicts
from karpenter_tpu_torch.scheduling.taints import (
    KNOWN_EPHEMERAL_TAINTS,
    Taints,
    UNREGISTERED_NO_EXECUTE_TAINT,
)
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.operator import logging as klog

_log = klog.logger("nodeclaim.lifecycle")

LAUNCH_TTL = 300.0  # liveness.go: unlaunched claims die after 5m
REGISTRATION_TTL = 900.0  # liveness.go:46-51: unregistered after 15m

_NODECLAIMS_TERMINATED = global_registry.counter(
    "karpenter_nodeclaims_terminated_total",
    "nodeclaims terminated",
    labels=["nodepool"],
)
_NODES_CREATED = global_registry.counter(
    "karpenter_nodes_created_total", "nodes created", labels=["nodepool"]
)
_NODECLAIMS_DISRUPTED = global_registry.counter(
    "karpenter_nodeclaims_disrupted_total",
    "nodeclaims disrupted",
    labels=["reason", "nodepool", "capacity_type"],
)


class LifecycleController:
    def __init__(
        self,
        store: Store,
        cloud_provider: CloudProvider,
        recorder: Recorder,
        clock: Clock,
        journal: Optional[Journal] = None,
    ):
        self.store = store
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.clock = clock
        self.journal = journal

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            self.finalize(claim)
            return
        if wk.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            claim.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
        for step in (
            self._launch,
            self._registration,
            self._initialization,
            self._liveness,
        ):
            step(claim)
            if self.store.try_get("NodeClaim", claim.metadata.name) is None:
                return  # a step deleted the claim
        self.store.apply(claim)

    # -- launch (launch.go:45-124) ------------------------------------------

    def _launch(self, claim: NodeClaim) -> None:
        if claim.condition_is_true(CONDITION_LAUNCHED):
            return
        # the launch hop re-joins the claim's scheduling-journey trace (the
        # provisioner linked it at create); the breaker's cloudprovider
        # span nests under this one, so breaker state lands in the journey
        # Idempotency key: stamped once per claim (derived from its uid, so
        # retries of the SAME claim reuse it) and carried as an annotation
        # into cloud_provider.create — an ambiguous failure (ack-then-raise,
        # breaker timeout, crash between ack and the done record) retried
        # next pass resolves to the instance already launched instead of
        # materializing a second node.
        key = claim.metadata.annotations.get(IDEMPOTENCY_ANNOTATION, "")
        if not key:
            key = f"launch/{claim.metadata.uid}"
            claim.metadata.annotations[IDEMPOTENCY_ANNOTATION] = key
        tracer = tracing.tracer()
        with tracer.span(
            "nodeclaim.launch",
            parent=tracer.linked("nodeclaim", claim.metadata.name),
            nodeclaim=claim.metadata.name,
        ) as span:
            seq = None
            if self.journal is not None:
                seq = self.journal.intent(
                    "nodeclaim.launch",
                    uid=claim.metadata.uid,
                    key=key,
                    nodeclaim=claim.metadata.name,
                )
            try:
                created = self.cloud_provider.create(claim)
            except InsufficientCapacityError as e:
                if seq is not None:
                    self.journal.failed(seq, error=str(e))
                span.fail(e)
                span.set_attr(outcome="insufficient_capacity")
                self.recorder.publish(
                    Event(claim, "Warning", "InsufficientCapacityError", str(e))
                )
                self._delete_claim(claim, "insufficient_capacity")
                return
            except NodeClassNotReadyError as e:
                if seq is not None:
                    self.journal.failed(seq, error=str(e))
                span.fail(e)
                span.set_attr(outcome="nodeclass_not_ready")
                self._delete_claim(claim, "nodeclass_not_ready")
                return
            except CreateError as e:
                # ambiguous: the provider may have acknowledged before
                # raising — the intent stays journaled as failed, but the
                # idempotency key makes the retry converge on whatever
                # actually launched
                if seq is not None:
                    self.journal.failed(seq, error=str(e))
                span.fail(e)
                span.set_attr(outcome="launch_failed")
                claim.set_condition(
                    CONDITION_LAUNCHED,
                    "Unknown",
                    reason=e.condition_reason or "LaunchFailed",
                    message=e.condition_message[:300],
                    now=self.clock.now(),
                )
                return
            if seq is not None:
                self.journal.done(seq, provider_id=created.status.provider_id)
            _populate_node_claim_details(claim, created)
            claim.set_condition(CONDITION_LAUNCHED, "True", now=self.clock.now())
            span.set_attr(
                outcome="launched",
                instance_type=claim.metadata.labels.get(wk.LABEL_INSTANCE_TYPE, ""),
            )
            _log.info(
                "launched nodeclaim",
                nodeclaim=claim.metadata.name,
                provider_id=claim.status.provider_id,
                instance_type=claim.metadata.labels.get(wk.LABEL_INSTANCE_TYPE, ""),
            )

    def _delete_claim(self, claim: NodeClaim, reason: str) -> None:
        _NODECLAIMS_DISRUPTED.inc(
            {
                "reason": reason,
                "nodepool": claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, ""),
                "capacity_type": claim.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY, ""),
            }
        )
        claim.metadata.finalizers = [
            f for f in claim.metadata.finalizers if f != wk.TERMINATION_FINALIZER
        ]
        # only "already gone" is benign here — typed not-found from the
        # store or the cloud; anything else is a real failure that must
        # surface to the reconciler harness (backoff + error metric)
        # instead of being swallowed
        try:
            self.store.apply(claim)
            self.store.delete(claim)
        except (StoreNotFound, NodeClaimNotFoundError):
            pass

    # -- registration (registration.go:46-116) ------------------------------

    def _registration(self, claim: NodeClaim) -> None:
        if claim.condition_is_true(CONDITION_REGISTERED):
            return
        if not claim.condition_is_true(CONDITION_LAUNCHED):
            return
        node = self._node_for_claim(claim)
        if node is None:
            claim.set_condition(
                CONDITION_REGISTERED,
                "Unknown",
                reason="NodeNotFound",
                message="Node not registered with cluster",
                now=self.clock.now(),
            )
            return
        self._sync_node(claim, node)
        now = self.clock.now()
        claim.set_condition(CONDITION_REGISTERED, "True", now=now)
        claim.status.node_name = node.metadata.name
        # registration hop: the wait from launch to the node joining the
        # cluster, recorded retroactively (start = the launch transition)
        tracer = tracing.tracer()
        launched = claim.get_condition(CONDITION_LAUNCHED)
        tracer.event(
            "nodeclaim.registration",
            parent=tracer.linked("nodeclaim", claim.metadata.name),
            start=min(
                launched.last_transition_time
                if launched is not None
                else claim.metadata.creation_timestamp,
                now,
            ),
            nodeclaim=claim.metadata.name,
            node=node.metadata.name,
        )
        _NODES_CREATED.inc(
            {"nodepool": claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")}
        )
        pool = self.store.try_get(
            "NodePool", claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
        )
        if pool is not None:
            pool.set_condition(
                CONDITION_NODE_REGISTRATION_HEALTHY, "True", now=self.clock.now()
            )
            self.store.apply(pool)

    def _node_for_claim(self, claim: NodeClaim) -> Optional[Node]:
        matches = self.store.list(
            "Node", predicate=lambda n: n.spec.provider_id == claim.status.provider_id
        )
        if len(matches) != 1:
            return None
        return matches[0]

    def _sync_node(self, claim: NodeClaim, node: Node) -> None:
        """registration.go:113-141: finalizer, owner ref, taints/labels sync,
        unregistered taint removal."""
        if wk.TERMINATION_FINALIZER not in node.metadata.finalizers:
            node.metadata.finalizers.append(wk.TERMINATION_FINALIZER)
        from karpenter_tpu_torch.apis.core import OwnerReference

        if not any(r.kind == "NodeClaim" for r in node.metadata.owner_references):
            node.metadata.owner_references.append(
                OwnerReference(
                    kind="NodeClaim",
                    name=claim.metadata.name,
                    uid=claim.metadata.uid,
                    block_owner_deletion=True,
                )
            )
        if node.metadata.labels.get(wk.NODE_DO_NOT_SYNC_TAINTS_LABEL_KEY) != "true":
            node.spec.taints = list(
                Taints(node.spec.taints)
                .merge(claim.spec.taints)
                .merge(claim.spec.startup_taints)
            )
        node.metadata.annotations.update(claim.metadata.annotations)
        node.spec.taints = [
            t for t in node.spec.taints if not t.match(UNREGISTERED_NO_EXECUTE_TAINT)
        ]
        node.metadata.labels.update(claim.metadata.labels)
        node.metadata.labels[wk.NODE_REGISTERED_LABEL_KEY] = "true"
        self.store.apply(node)

    # -- initialization (initialization.go:46-133) --------------------------

    def _initialization(self, claim: NodeClaim) -> None:
        if claim.condition_is_true(CONDITION_INITIALIZED):
            return
        if not claim.condition_is_true(CONDITION_REGISTERED):
            return
        node = self._node_for_claim(claim)
        now = self.clock.now()
        if node is None:
            claim.set_condition(
                CONDITION_INITIALIZED, "Unknown", reason="NodeNotFound",
                message="Node not registered with cluster", now=now,
            )
            return
        ready = next((c for c in node.status.conditions if c.type == "Ready"), None)
        if ready is None or ready.status != "True":
            claim.set_condition(
                CONDITION_INITIALIZED, "Unknown", reason="NodeNotReady",
                message="Node status is NotReady", now=now,
            )
            return
        startup = list(claim.spec.startup_taints)
        for t in node.spec.taints:
            if any(t.match(s) for s in startup):
                claim.set_condition(
                    CONDITION_INITIALIZED, "Unknown", reason="StartupTaintsExist",
                    message=f"StartupTaint {t.key} still exists", now=now,
                )
                return
            if any(t.match(e) for e in KNOWN_EPHEMERAL_TAINTS):
                claim.set_condition(
                    CONDITION_INITIALIZED, "Unknown", reason="KnownEphemeralTaintsExist",
                    message=f"KnownEphemeralTaint {t.key} still exists", now=now,
                )
                return
        for name, quantity in claim.status.allocatable.items():
            if quantity > 0 and node.status.allocatable.get(name, 0.0) <= 0:
                claim.set_condition(
                    CONDITION_INITIALIZED, "Unknown", reason="ResourceNotRegistered",
                    message=f"Resource {name!r} was requested but not registered", now=now,
                )
                return
        node.metadata.labels[wk.NODE_INITIALIZED_LABEL_KEY] = "true"
        self.store.apply(node)
        claim.set_condition(CONDITION_INITIALIZED, "True", now=now)

    # -- liveness (liveness.go:46-160) --------------------------------------

    def _liveness(self, claim: NodeClaim) -> None:
        """Timeouts run from the relevant condition's last TRANSITION into
        its current non-True state, not from the creation timestamp
        (liveness.go:79-97): a claim whose launch reconcile first ran late
        gets the full window from that first attempt. Repeated failures
        keep the same status, so they do NOT extend the window."""
        if claim.condition_is_true(CONDITION_REGISTERED):
            return
        now = self.clock.now()
        launched = claim.get_condition(CONDITION_LAUNCHED)
        if launched is None or launched.status != "True":
            base = (
                launched.last_transition_time
                if launched is not None
                else claim.metadata.creation_timestamp
            )
            if now - base > LAUNCH_TTL:
                self._delete_claim(claim, "liveness")
            return
        registered = claim.get_condition(CONDITION_REGISTERED)
        base = (
            registered.last_transition_time
            if registered is not None
            else claim.metadata.creation_timestamp
        )
        if now - base > REGISTRATION_TTL:
            pool = self.store.try_get(
                "NodePool", claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
            if pool is not None:
                pool.set_condition(
                    CONDITION_NODE_REGISTRATION_HEALTHY,
                    "False",
                    reason="RegistrationFailed",
                    message="Node not registered within registration TTL",
                    now=now,
                )
                self.store.apply(pool)
            self._delete_claim(claim, "liveness")

    # -- termination (controller.go:172-290) --------------------------------

    def finalize(self, claim: NodeClaim) -> None:
        if wk.TERMINATION_FINALIZER not in claim.metadata.finalizers:
            return
        # Stamp the termination deadline for TGP enforcement
        if (
            claim.spec.termination_grace_period is not None
            and wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
            not in claim.metadata.annotations
        ):
            deadline = (
                claim.metadata.deletion_timestamp + claim.spec.termination_grace_period
            )
            claim.metadata.annotations[
                wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
            ] = str(deadline)
            self.store.apply(claim)
        # Linked nodes drain/terminate first (their own finalizer pipeline)
        nodes = self.store.list(
            "Node", predicate=lambda n: n.spec.provider_id == claim.status.provider_id
        )
        for node in nodes:
            if node.metadata.deletion_timestamp is None:
                self.store.delete(node)
        if any(
            self.store.try_get("Node", n.metadata.name) is not None for n in nodes
        ):
            return  # wait for node termination
        if claim.condition_is_true(CONDITION_LAUNCHED):
            seq = None
            if self.journal is not None:
                seq = self.journal.intent(
                    "nodeclaim.delete",
                    uid=claim.metadata.uid,
                    key=f"delete/{claim.metadata.uid}",
                    nodeclaim=claim.metadata.name,
                    provider_id=claim.status.provider_id,
                )
            try:
                self.cloud_provider.delete(claim)
                if seq is not None:
                    self.journal.done(seq)
                claim.set_condition(
                    CONDITION_INSTANCE_TERMINATING, "True", now=self.clock.now()
                )
                self.store.apply(claim)
                return  # wait for the instance to disappear
            except NodeClaimNotFoundError:
                # already gone: the delete's outcome is satisfied
                if seq is not None:
                    self.journal.done(seq, barrier=False, missing=True)
            except Exception as e:  # noqa: BLE001 — close the intent, then surface
                if seq is not None:
                    self.journal.failed(seq, error=str(e))
                raise
        _NODECLAIMS_TERMINATED.inc(
            {"nodepool": claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")}
        )
        self.store.remove_finalizer(claim, wk.TERMINATION_FINALIZER)


def _populate_node_claim_details(claim: NodeClaim, created: NodeClaim) -> None:
    """launch.go:126-140: provider labels < requirement labels < user labels."""
    labels = dict(created.metadata.labels)
    labels.update(requirements_from_dicts(claim.spec.requirements).labels())
    labels.update(claim.metadata.labels)
    claim.metadata.labels = labels
    claim.metadata.annotations.update(created.metadata.annotations)
    claim.status.provider_id = created.status.provider_id
    claim.status.image_id = created.status.image_id
    claim.status.allocatable = dict(created.status.allocatable)
    claim.status.capacity = dict(created.status.capacity)
