"""Node auto-repair: force-delete the NodeClaims of unhealthy nodes per
provider repair policies, with a circuit breaker scoped to the node's own
NodePool (cluster-wide for unlabeled nodes).

Mirrors the reference's node/health/controller.go:59-226.
"""

from __future__ import annotations

import math

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Node
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.utils.clock import Clock

# Up to 20% of a NodePool's nodes (rounded UP to the nearest whole node)
# may be unhealthy before repair is blocked (controller.go:48,190-216)
ALLOWED_UNHEALTHY_PERCENT = 0.2

_REPAIRED_TOTAL = global_registry.counter(
    "karpenter_nodeclaims_unhealthy_disrupted_total",
    "unhealthy nodeclaims force-deleted by node auto-repair",
    labels=["condition", "nodepool", "capacity_type"],
)
_DISRUPTED_TOTAL = global_registry.counter(
    "karpenter_nodeclaims_disrupted_total",
    "nodeclaims disrupted",
    labels=["reason", "nodepool", "capacity_type"],
)


class HealthController:
    def __init__(
        self,
        store: Store,
        cloud_provider: CloudProvider,
        recorder: Recorder,
        clock: Clock,
        enabled: bool = False,
    ):
        self.store = store
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.clock = clock
        self.enabled = enabled

    def reconcile(self, node: Node) -> None:
        if not self.enabled:
            return
        if node.metadata.deletion_timestamp is not None:
            return
        policies = self.cloud_provider.repair_policies()
        if not policies:
            return
        for policy in policies:
            cond = next(
                (c for c in node.status.conditions if c.type == policy.condition_type),
                None,
            )
            if cond is None or cond.status != policy.condition_status:
                continue
            elapsed = self.clock.now() - cond.last_transition_time
            if elapsed < policy.toleration_duration:
                continue
            # threshold scoped to the node's own NodePool when labeled,
            # the whole cluster for standalone claims (controller.go:97-118)
            pool = node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
            if not self._healthy(pool):
                scope = f"nodepool {pool!r}" if pool else "the cluster"
                self.recorder.publish(
                    Event(
                        node, "Warning", "NodeRepairBlocked",
                        f"Disruption blocked: more than 20% of nodes in "
                        f"{scope} are unhealthy",
                    )
                )
                return
            claim = self._claim_for(node)
            if claim is None:
                return
            # force termination: stamp the TGP deadline to NOW so drain
            # overrides pod grace (controller.go:170-186) — an EARLIER
            # stamp is preserved, and nodepool TGP is deliberately ignored
            self._annotate_termination_now(claim)
            if claim.metadata.deletion_timestamp is None:
                # metrics/event only on the actual delete, never on the
                # re-reconciles of an already-terminating claim
                # (deleteNodeClaim, controller.go:127-148)
                pool_labels = {
                    "nodepool": pool or "",
                    "capacity_type": node.metadata.labels.get(
                        wk.CAPACITY_TYPE_LABEL_KEY, ""
                    ),
                }
                _DISRUPTED_TOTAL.inc({"reason": "unhealthy", **pool_labels})
                _REPAIRED_TOTAL.inc(
                    {"condition": policy.condition_type, **pool_labels}
                )
                self.recorder.publish(
                    Event(
                        node, "Warning", "NodeUnhealthy",
                        f"Force-terminating: {policy.condition_type}="
                        f"{policy.condition_status} for {int(elapsed)}s",
                    )
                )
                self.store.delete(claim)
            return

    def _claim_for(self, node: Node):
        from karpenter_tpu_torch.utils.node import claim_for_node

        return claim_for_node(self.store, node)

    def _annotate_termination_now(self, claim) -> None:
        raw = claim.metadata.annotations.get(
            wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
        )
        now = self.clock.now()
        if raw is not None:
            try:
                if float(raw) <= now:
                    return  # an equal-or-earlier deadline stays
            except ValueError:
                pass
        claim.metadata.annotations[
            wk.NODECLAIM_TERMINATION_TIMESTAMP_ANNOTATION_KEY
        ] = str(now)
        self.store.apply(claim)

    def _healthy(self, pool: str | None) -> bool:
        """Unhealthy count must stay within ceil(20% of nodes), scoped to
        the NodePool when given (controller.go:190-216 round-up)."""
        if pool is not None:
            nodes = self.store.list(
                "Node",
                predicate=lambda n: n.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
                == pool,
            )
        else:
            nodes = self.store.list("Node")
        if not nodes:
            return True
        policies = self.cloud_provider.repair_policies()
        unhealthy = 0
        for n in nodes:
            for policy in policies:
                cond = next(
                    (c for c in n.status.conditions if c.type == policy.condition_type),
                    None,
                )
                if cond is not None and cond.status == policy.condition_status:
                    unhealthy += 1
                    break
        threshold = math.ceil(ALLOWED_UNHEALTHY_PERCENT * len(nodes))
        return unhealthy <= threshold
