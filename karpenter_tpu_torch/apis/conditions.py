"""Shared status-condition helpers for API objects whose status carries a
list[Condition] (NodeClaim, NodePool, NodeOverlay). One implementation so
transition-time bumping stays consistent (reference: operatorpkg status
conditions), and the single chokepoint where the per-CRD condition metrics
the reference auto-emits (controllers.go:102-120) are recorded: every status
flip increments the transitions counter and — when the condition had a prior
transition time — observes how long the previous status was held."""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis.core import Condition
from karpenter_tpu_torch.metrics import global_registry

CONDITION_TRANSITIONS_TOTAL = global_registry.counter(
    "karpenter_status_condition_transitions_total",
    "status-condition transitions per kind/type/status",
    labels=["kind", "type", "status"],
)
CONDITION_TRANSITION_SECONDS = global_registry.histogram(
    "karpenter_status_condition_transition_seconds",
    "time a condition held its previous status before transitioning",
    labels=["kind", "type", "status"],
)


class ConditionedStatus:
    """Mixin for objects exposing `.status.conditions: list[Condition]`."""

    def get_condition(self, condition_type: str) -> Optional[Condition]:
        for c in self.status.conditions:
            if c.type == condition_type:
                return c
        return None

    def _record_transition(
        self, condition_type: str, status: str, held_for: Optional[float]
    ) -> None:
        kind = getattr(self, "KIND", type(self).__name__)
        labels = {"kind": kind, "type": condition_type, "status": status}
        CONDITION_TRANSITIONS_TOTAL.inc(labels)
        if held_for is not None and held_for >= 0.0:
            CONDITION_TRANSITION_SECONDS.observe(held_for, labels)

    def set_condition(
        self,
        condition_type: str,
        status: str,
        reason: str = "",
        message: str = "",
        now: float = 0.0,
    ) -> Condition:
        existing = self.get_condition(condition_type)
        if existing is not None:
            if existing.status != status:
                self._record_transition(
                    condition_type, status, now - existing.last_transition_time
                )
                existing.last_transition_time = now
            existing.status = status
            existing.reason = reason
            existing.message = message
            return existing
        self._record_transition(condition_type, status, None)
        c = Condition(
            type=condition_type,
            status=status,
            reason=reason,
            message=message,
            last_transition_time=now,
        )
        self.status.conditions.append(c)
        return c

    def clear_condition(self, condition_type: str) -> None:
        self.status.conditions = [
            c for c in self.status.conditions if c.type != condition_type
        ]

    def condition_is_true(self, condition_type: str) -> bool:
        c = self.get_condition(condition_type)
        return c is not None and c.status == "True"
