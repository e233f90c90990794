"""Consolidation base: shared simulate-then-price-gate logic.

Mirrors the reference's disruption/consolidation.go:45-329.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import CONDITION_CONSOLIDATABLE
from karpenter_tpu_torch.apis.nodepool import (
    CONSOLIDATION_POLICY_WHEN_EMPTY_OR_UNDERUTILIZED,
)
from karpenter_tpu_torch.cloudprovider.types import Offerings
from karpenter_tpu_torch.controllers.disruption.helpers import (
    CandidateDeletingError,
    simulate_scheduling,
)
from karpenter_tpu_torch.controllers.disruption.types import (
    Candidate,
    Command,
    replacements_from_node_claims,
)
from karpenter_tpu_torch.events.recorder import Event
from karpenter_tpu_torch.scheduling.requirements import Operator, Requirement, Requirements

CONSOLIDATION_TTL = 15.0  # seconds (consolidation.go:46)
MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT = 15  # consolidation.go:49

# sentinel: get_candidate_prices legitimately returns None, so "not
# provided" needs its own marker for consolidation_decision
_UNSET = object()


class Consolidation:
    """Shared state/machinery for the consolidation-family methods."""

    def __init__(self, clock, cluster, store, provisioner, cloud_provider, recorder, queue):
        self.clock = clock
        self.cluster = cluster
        self.store = store
        self.provisioner = provisioner
        self.cloud_provider = cloud_provider
        self.recorder = recorder
        self.queue = queue
        self.last_consolidation_state = -1.0
        self.spot_to_spot_enabled = provisioner.options.feature_gates.spot_to_spot_consolidation

    def is_consolidated(self) -> bool:
        """Cluster unchanged since our last no-op decision (consolidation.go:74-76)."""
        return self.last_consolidation_state == self.cluster.consolidation_state()

    def mark_consolidated(self) -> None:
        self.last_consolidation_state = self.cluster.consolidation_state()

    def should_disrupt(self, c: Candidate) -> bool:
        """consolidation.go:82-106."""
        if c.instance_type is None:
            self._unconsolidatable(c, "Instance type not found")
            return False
        if wk.CAPACITY_TYPE_LABEL_KEY not in c.labels():
            self._unconsolidatable(c, f"Node does not have label {wk.CAPACITY_TYPE_LABEL_KEY}")
            return False
        if wk.LABEL_TOPOLOGY_ZONE not in c.labels():
            self._unconsolidatable(c, f"Node does not have label {wk.LABEL_TOPOLOGY_ZONE}")
            return False
        if c.node_pool.spec.disruption.consolidate_after is None:
            self._unconsolidatable(c, "NodePool has consolidation disabled")
            return False
        if (
            c.node_pool.spec.disruption.consolidation_policy
            != CONSOLIDATION_POLICY_WHEN_EMPTY_OR_UNDERUTILIZED
        ):
            self._unconsolidatable(c, "NodePool has non-empty consolidation disabled")
            return False
        return c.node_claim.condition_is_true(CONDITION_CONSOLIDATABLE)

    def _unconsolidatable(self, c: Candidate, message: str) -> None:
        self.recorder.publish(
            Event(c.node_claim, "Normal", "Unconsolidatable", message)
        )

    def sort_candidates(self, candidates: list[Candidate]) -> list[Candidate]:
        return sorted(candidates, key=lambda c: c.disruption_cost)

    # -- the decision core (consolidation.go:133-227) -----------------------

    def compute_consolidation(self, *candidates: Candidate) -> Command:
        try:
            results = simulate_scheduling(
                self.store, self.cluster, self.provisioner, *candidates
            )
        except CandidateDeletingError:
            return Command()
        return self.consolidation_decision(list(candidates), results)

    def consolidation_decision(
        self,
        candidates: list[Candidate],
        results,
        candidate_price=_UNSET,
        events: Optional[list] = None,
    ) -> Command:
        """Everything after the simulation: the simulate-then-price-gate
        verdict for `candidates` given its scheduling `results`. Split from
        compute_consolidation so the frontier search can feed many probes'
        results from one coalesced batch, with `candidate_price` precomputed
        by the prefix reduction (ops/frontier.PrefixPrices) instead of
        re-walking the prefix per probe.

        `events`: the frontier evaluates probes the sequential search may
        never visit; passing a list DEFERS the single-candidate
        Unconsolidatable events into it as (candidate, message) so the
        caller publishes exactly the ones the sequential walk would —
        event-stream parity is part of the decisions-byte-identical
        contract."""

        def note(candidate: Candidate, message: str) -> None:
            if events is None:
                self._unconsolidatable(candidate, message)
            else:
                events.append((candidate, message))

        if not results.all_non_pending_pods_scheduled():
            if len(candidates) == 1:
                note(candidates[0], results.non_pending_pod_scheduling_errors())
            return Command()

        if len(results.new_node_claims) == 0:
            return Command(candidates=list(candidates), results=results)

        if len(results.new_node_claims) != 1:
            if len(candidates) == 1:
                note(
                    candidates[0],
                    f"Can't remove without creating {len(results.new_node_claims)} candidates",
                )
            return Command()

        if candidate_price is _UNSET:
            candidate_price = get_candidate_prices(candidates)
        if candidate_price is None:
            return Command()

        all_spot = all(c.capacity_type == wk.CAPACITY_TYPE_SPOT for c in candidates)
        replacement = results.new_node_claims[0]
        from karpenter_tpu_torch.cloudprovider.types import order_by_price

        replacement.instance_type_options = order_by_price(
            replacement.instance_type_options, replacement.requirements
        )

        if all_spot and replacement.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY).has(
            wk.CAPACITY_TYPE_SPOT
        ):
            return self._compute_spot_to_spot(
                candidates, results, candidate_price, note
            )

        try:
            replacement.remove_instance_type_options_by_price_and_min_values(
                replacement.requirements, candidate_price
            )
        except ValueError as e:
            if len(candidates) == 1:
                note(candidates[0], f"Filtering by price: {e}")
            return Command()
        if not replacement.instance_type_options:
            if len(candidates) == 1:
                note(candidates[0], "Can't replace with a cheaper node")
            return Command()

        # Prefer spot when both capacity types remain (consolidation.go:216-219)
        ct = replacement.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY)
        if ct.has(wk.CAPACITY_TYPE_SPOT) and ct.has(wk.CAPACITY_TYPE_ON_DEMAND):
            replacement.requirements.add(
                Requirement(
                    wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [wk.CAPACITY_TYPE_SPOT]
                )
            )
        return Command(
            candidates=list(candidates),
            replacements=replacements_from_node_claims(results.new_node_claims),
            results=results,
        )

    def _compute_spot_to_spot(self, candidates, results, candidate_price, note=None) -> Command:
        """consolidation.go:229-301: spot→spot needs the feature gate and ≥15
        cheaper types (single-candidate case) to avoid flapping."""
        if note is None:
            def note(candidate, message):
                self._unconsolidatable(candidate, message)
        if not self.spot_to_spot_enabled:
            if len(candidates) == 1:
                note(
                    candidates[0],
                    "SpotToSpotConsolidation is disabled, can't replace a spot node with a spot node",
                )
            return Command()
        replacement = results.new_node_claims[0]
        replacement.requirements.add(
            Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [wk.CAPACITY_TYPE_SPOT])
        )
        from karpenter_tpu_torch.cloudprovider.types import compatible_instance_types

        replacement.instance_type_options = [
            it
            for it in replacement.instance_type_options
            if it.offerings.available().has_compatible(replacement.requirements)
        ]
        try:
            replacement.remove_instance_type_options_by_price_and_min_values(
                replacement.requirements, candidate_price
            )
        except ValueError as e:
            if len(candidates) == 1:
                note(candidates[0], f"Filtering by price: {e}")
            return Command()
        if not replacement.instance_type_options:
            if len(candidates) == 1:
                note(candidates[0], "Can't replace with a cheaper node")
            return Command()
        if len(candidates) > 1:
            return Command(
                candidates=list(candidates),
                replacements=replacements_from_node_claims(results.new_node_claims),
                results=results,
            )
        if len(replacement.instance_type_options) < MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT:
            note(
                candidates[0],
                f"SpotToSpotConsolidation requires {MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT} "
                f"cheaper instance type options than the current candidate to consolidate, "
                f"got {len(replacement.instance_type_options)}",
            )
            return Command()
        # Launch with exactly the 15 cheapest (or enough for minValues) so the
        # new spot node sits deep enough in the price curve to stick.
        keep = MIN_INSTANCE_TYPES_FOR_SPOT_TO_SPOT
        if replacement.requirements.has_min_values():
            from karpenter_tpu_torch.cloudprovider.types import satisfies_min_values

            needed, _, _ = satisfies_min_values(
                replacement.instance_type_options, replacement.requirements
            )
            keep = max(keep, needed)
        replacement.instance_type_options = replacement.instance_type_options[:keep]
        return Command(
            candidates=list(candidates),
            replacements=replacements_from_node_claims(results.new_node_claims),
            results=results,
        )


def get_candidate_prices(candidates) -> Optional[float]:
    """Sum of the candidates' current offering prices (consolidation.go:304-329)."""
    price = 0.0
    for c in candidates:
        reqs = Requirements.from_labels(c.state_node.labels())
        compatible = Offerings(c.instance_type.offerings).compatible(reqs)
        if not compatible:
            if reqs.get(wk.CAPACITY_TYPE_LABEL_KEY).has(wk.CAPACITY_TYPE_RESERVED):
                return 0.0
            return None
        price += compatible.cheapest().price
    return price
