"""Disruption controller: 10s polling loop running the methods in order;
first success wins.

Mirrors the reference's disruption/controller.go:55-250.
"""

from __future__ import annotations

from typing import Optional, Sequence

from karpenter_tpu_torch.apis.nodeclaim import CONDITION_DISRUPTION_REASON
from karpenter_tpu_torch.cloudprovider.types import CloudProvider
from karpenter_tpu_torch.controllers.disruption.consolidation import (
    CONSOLIDATION_TTL,
    Consolidation,
)
from karpenter_tpu_torch.controllers.disruption.helpers import (
    build_disruption_budget_mapping,
    get_candidates,
)
from karpenter_tpu_torch.controllers.disruption.methods import (
    Drift,
    Emptiness,
    MultiNodeConsolidation,
    SingleNodeConsolidation,
)
from karpenter_tpu_torch.controllers.disruption.queue import Queue
from karpenter_tpu_torch.controllers.disruption.types import DECISION_NOOP
from karpenter_tpu_torch.controllers.disruption.validation import ValidationError
from karpenter_tpu_torch.events.recorder import Recorder
from karpenter_tpu_torch.metrics import global_registry, measure
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import (
    clear_node_claims_condition,
    require_no_schedule_taint,
)
from karpenter_tpu_torch.utils.clock import Clock

POLLING_PERIOD = 10.0  # controller.go:66

_log = klog.logger("disruption")

_ELIGIBLE_NODES = global_registry.gauge(
    "karpenter_voluntary_disruption_eligible_nodes",
    "nodes eligible for disruption per reason",
    labels=["reason"],
)
_EVAL_DURATION = global_registry.histogram(
    "karpenter_voluntary_disruption_decision_evaluation_duration_seconds",
    "disruption method evaluation duration",
    labels=["reason", "consolidation_type"],
)
_FAILED_VALIDATIONS = global_registry.counter(
    "karpenter_voluntary_disruption_failed_validations_total",
    "disruption commands that failed their two-phase re-validation",
)


def new_methods(clock, cluster, store, provisioner, cloud_provider, recorder, queue):
    """controller.go:94-103: Emptiness → Drift → MultiNode → SingleNode.

    Each method gets its OWN Consolidation (the reference embeds the struct
    by value, so lastConsolidationState is per-method — one method's no-op
    must not short-circuit the others)."""

    def c():
        return Consolidation(
            clock, cluster, store, provisioner, cloud_provider, recorder, queue
        )

    return [
        Emptiness(c()),
        Drift(store, cluster, provisioner, recorder),
        MultiNodeConsolidation(c()),
        SingleNodeConsolidation(c()),
    ]


class Controller:
    def __init__(
        self,
        clock: Clock,
        store: Store,
        provisioner,
        cloud_provider: CloudProvider,
        recorder: Recorder,
        cluster: Cluster,
        queue: Queue,
        methods: Optional[Sequence] = None,
    ):
        self.clock = clock
        self.store = store
        self.provisioner = provisioner
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.cluster = cluster
        self.queue = queue
        self.methods = (
            list(methods)
            if methods is not None
            else new_methods(
                clock, cluster, store, provisioner, cloud_provider, recorder, queue
            )
        )
        self._next_run = 0.0
        # (command, method) awaiting TTL re-validation — two-phase validation:
        # the reference parks a goroutine on the TTL while informers keep
        # running (validation.go:152-282); the cooperative loop parks the
        # command instead and re-validates on a later pass so the churn
        # re-check sees genuinely fresh state.
        self._pending: Optional[tuple] = None
        self._pending_due = 0.0

    def reconcile(self) -> bool:
        """One pass; returns True if a command was started (requeue fast)."""
        if self.clock.now() < self._next_run and self._pending is None:
            return False
        if not self.cluster.synced():
            return False
        if self._pending is not None:
            return self._revalidate_pending()
        # Clean leftover disruption taints/conditions from restarts or
        # abandoned commands (controller.go:131-152).
        # view, not copies: both cleanup helpers act through the store by
        # name and only read the StateNodes
        outdated = [
            n
            for n in self.cluster.state_nodes_view()
            if not self.queue.has_any(n.provider_id()) and not n.is_marked_for_deletion()
        ]
        require_no_schedule_taint(self.store, False, *outdated)
        clear_node_claims_condition(self.store, CONDITION_DISRUPTION_REASON, *outdated)

        from karpenter_tpu_torch.solverd import SolverRejection, TransportError

        # candidate bases shared by this pass's methods (helpers.get_candidates)
        pass_cache: dict = {}
        from karpenter_tpu_torch.observability import slo

        tenant = getattr(self.provisioner.options, "cluster_name", "")
        for method in self.methods:
            try:
                if self._disrupt(method, pass_cache):
                    slo.engine().record(
                        "solverd-availability", good=1, tenant=tenant
                    )
                    return True
            except (SolverRejection, TransportError) as e:
                # The solver shed our simulations (or the sidecar is down):
                # disruption is deferrable by definition — back off for a
                # polling period instead of crashing the operator loop.
                # port: a KernelError (a device fault, in-process or typed
                # across the sidecar's socket) is neither and propagates
                slo.engine().record(
                    "solverd-availability", bad=1, tenant=tenant
                )
                _log.warning(
                    "disruption evaluation shed by solver; backing off",
                    method=method.reason(), error=type(e).__name__,
                )
                break
        else:
            # the whole evaluation ran without a shed: one good event on
            # the availability objective (the burn-rate denominator)
            slo.engine().record("solverd-availability", good=1, tenant=tenant)
        self._next_run = self.clock.now() + POLLING_PERIOD
        return False

    def _revalidate_pending(self) -> bool:
        """Phase two: the TTL elapsed — re-verify against fresh state and
        start the command, or abandon it (validation.go:152-282)."""
        if self.clock.now() < self._pending_due:
            return False
        cmd, method = self._pending
        self._pending = None
        try:
            cmd = method.validator.validate(cmd)
        except ValidationError:
            _FAILED_VALIDATIONS.inc()
            return False
        cmd.creation_timestamp = self.clock.now()
        cmd.method = method
        self.queue.start_command(cmd)
        return True

    def _disrupt(self, method, pass_cache: Optional[dict] = None) -> bool:
        """controller.go:169-206."""
        labels = {
            "reason": method.reason().lower(),
            "consolidation_type": method.consolidation_type(),
        }
        with measure(_EVAL_DURATION, labels):
            candidates = get_candidates(
                self.store,
                self.cluster,
                self.recorder,
                self.clock,
                self.cloud_provider,
                method.should_disrupt,
                method.disruption_class(),
                self.queue,
                pass_cache=pass_cache,
                node_prefilter=getattr(method, "node_prefilter", None),
            )
            _ELIGIBLE_NODES.set(
                float(len(candidates)), {"reason": method.reason().lower()}
            )
            if not candidates:
                return False
            budgets = build_disruption_budget_mapping(
                self.store, self.cluster, self.clock, self.recorder, method.reason()
            )
            cmd = method.compute_command(budgets, *candidates)
            if cmd.decision() == DECISION_NOOP:
                return False
            if getattr(method, "validator", None) is not None:
                # Park for TTL re-validation instead of starting immediately.
                self._pending = (cmd, method)
                self._pending_due = self.clock.now() + CONSOLIDATION_TTL
                return True
            cmd.creation_timestamp = self.clock.now()
            cmd.method = method
            self.queue.start_command(cmd)
            return True
