"""Command validation: re-verify after a TTL against fresh state to defeat
pod churn.

Mirrors the reference's disruption/validation.go:35-320.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

from karpenter_tpu_torch.controllers.disruption.helpers import (
    build_disruption_budget_mapping,
    get_candidates,
    instance_types_are_subset,
    map_candidates,
    simulate_scheduling,
)
from karpenter_tpu_torch.controllers.disruption.types import (
    Candidate,
    Command,
    GRACEFUL_DISRUPTION_CLASS,
)


class ValidationError(Exception):
    """The command is no longer valid — abandon, don't fail (validation.go:35-49)."""


class _BaseValidator:
    """Validation is two-phase across controller passes: the disruption
    controller records a computed command with a TTL deadline and calls
    `validate` on a LATER reconcile pass, after informers and other
    controllers have run — so the churn re-check observes genuinely fresh
    state. (The reference blocks a goroutine on the TTL while informers run
    concurrently, validation.go:152-282; a blocking sleep in this
    single-threaded loop would stall every controller AND make the re-check
    vacuous.)"""

    def __init__(self, c, reason: str, filter_: Callable[[Candidate], bool], vtype: str):
        self.c = c
        self.reason = reason
        self.filter = filter_
        self.validation_type = vtype

    def _fresh_candidates(self, candidates: list[Candidate]) -> list[Candidate]:
        fresh = get_candidates(
            self.c.store,
            self.c.cluster,
            self.c.recorder,
            self.c.clock,
            self.c.cloud_provider,
            self.filter,
            GRACEFUL_DISRUPTION_CLASS,
            self.c.queue,
        )
        return map_candidates(candidates, fresh)


class EmptinessValidator(_BaseValidator):
    """Keeps the still-valid subset (validation.go:90-110, 178-210)."""

    def __init__(self, c):
        from karpenter_tpu_torch.apis.nodepool import DISRUPTION_REASON_EMPTY

        super().__init__(c, DISRUPTION_REASON_EMPTY, self._should_disrupt, "empty")

    def _should_disrupt(self, candidate: Candidate) -> bool:
        from karpenter_tpu_torch.controllers.disruption.methods import Emptiness

        return Emptiness(self.c, validator=self).should_disrupt(candidate)

    def validate(self, cmd: Command) -> Command:
        validated = self._fresh_candidates(cmd.candidates)
        if not validated:
            raise ValidationError(f"{len(cmd.candidates)} candidates are no longer valid")
        budgets = build_disruption_budget_mapping(
            self.c.store, self.c.cluster, self.c.clock, self.c.recorder, self.reason
        )
        valid = []
        for cn in validated:
            if self.c.cluster.is_node_nominated(cn.provider_id()):
                continue
            if budgets.get(cn.node_pool.metadata.name, 0) == 0:
                continue
            budgets[cn.node_pool.metadata.name] -= 1
            valid.append(cn)
        if not valid:
            raise ValidationError(
                "candidates failed validation: nominated or budget-constrained"
            )
        cmd.candidates = valid
        return cmd


class ConsolidationValidator(_BaseValidator):
    """All-or-nothing re-validation including a fresh simulation
    (validation.go:147-176, 213-270, validateCommand:237-270)."""

    def __init__(self, c, method, vtype: str):
        from karpenter_tpu_torch.apis.nodepool import DISRUPTION_REASON_UNDERUTILIZED

        super().__init__(
            c, DISRUPTION_REASON_UNDERUTILIZED, method.should_disrupt, vtype
        )

    def validate(self, cmd: Command) -> Command:
        validated = self._validate_candidates(cmd.candidates)
        self._validate_command(cmd, validated)
        self._validate_candidates(validated)
        return cmd

    def _validate_candidates(self, candidates: list[Candidate]) -> list[Candidate]:
        validated = self._fresh_candidates(candidates)
        if len(validated) != len(candidates):
            raise ValidationError(
                f"{len(candidates) - len(validated)} candidates are no longer valid"
            )
        budgets = build_disruption_budget_mapping(
            self.c.store, self.c.cluster, self.c.clock, self.c.recorder, self.reason
        )
        for vc in validated:
            if self.c.cluster.is_node_nominated(vc.provider_id()):
                raise ValidationError("a candidate was nominated during validation")
            if budgets.get(vc.node_pool.metadata.name, 0) == 0:
                raise ValidationError(
                    "a candidate can no longer be disrupted without violating budgets"
                )
            budgets[vc.node_pool.metadata.name] -= 1
        return validated

    def _validate_command(self, cmd: Command, candidates: list[Candidate]) -> None:
        if not candidates:
            raise ValidationError("no candidates")
        results = simulate_scheduling(
            self.c.store, self.c.cluster, self.c.provisioner, *candidates
        )
        if not results.all_non_pending_pods_scheduled():
            raise ValidationError(results.non_pending_pod_scheduling_errors())
        if len(results.new_node_claims) == 0:
            if len(cmd.replacements) == 0:
                return
            raise ValidationError("scheduling simulation produced new results")
        if len(results.new_node_claims) > 1 or len(cmd.replacements) == 0:
            raise ValidationError("scheduling simulation produced new results")
        if not instance_types_are_subset(
            cmd.replacements[0].node_claim.instance_type_options,
            results.new_node_claims[0].instance_type_options,
        ):
            raise ValidationError("scheduling simulation produced new results")
