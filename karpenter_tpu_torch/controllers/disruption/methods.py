"""The four disruption methods, tried in order: Emptiness → Drift →
MultiNodeConsolidation → SingleNodeConsolidation.

Mirrors emptiness.go:40-133, drift.go:52-111, multinodeconsolidation.go:40-226
(binary search over a sorted candidate prefix), and
singlenodeconsolidation.go:40-150 (cheapest-first with nodepool fairness).
"""

from __future__ import annotations

import math
from typing import Optional

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.apis.nodepool import (
    DISRUPTION_REASON_DRIFTED,
    DISRUPTION_REASON_EMPTY,
    DISRUPTION_REASON_UNDERUTILIZED,
)
from karpenter_tpu_torch.controllers.disruption.consolidation import Consolidation
from karpenter_tpu_torch.controllers.disruption.helpers import (
    CandidateDeletingError,
    FrontierSimulator,
    simulate_scheduling,
)
from karpenter_tpu_torch.controllers.disruption.types import (
    Candidate,
    Command,
    DECISION_DELETE,
    DECISION_NOOP,
    DECISION_REPLACE,
    EVENTUAL_DISRUPTION_CLASS,
    GRACEFUL_DISRUPTION_CLASS,
    replacements_from_node_claims,
)
from karpenter_tpu_torch.controllers.disruption.validation import (
    ConsolidationValidator,
    EmptinessValidator,
)
from karpenter_tpu_torch.events.recorder import Event
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.ops import fused as fused_mod
from karpenter_tpu_torch.scheduling.requirements import Requirements

MULTI_NODE_CONSOLIDATION_TIMEOUT = 60.0  # multinodeconsolidation.go:36
SINGLE_NODE_CONSOLIDATION_TIMEOUT = 180.0  # singlenodeconsolidation.go:34

_CONSOLIDATION_TIMEOUTS = global_registry.counter(
    "karpenter_voluntary_disruption_consolidation_timeouts_total",
    "consolidation computations that hit their timeout",
    labels=["consolidation_type"],
)
MAX_PARALLEL_CONSOLIDATION = 100  # multinodeconsolidation.go:85-87


def _slo_deadline(good: int = 0, bad: int = 0) -> None:
    """Consolidation-deadline SLO feed: a computation that finished inside
    its timeout is good, one that hit the deadline is bad (zero-tolerance
    objective — any deadline hit is a breach)."""
    from karpenter_tpu_torch.observability import slo

    slo.engine().record("consolidation-deadline", good=good, bad=bad)


def _frontier_depth(c: Consolidation) -> int:
    """The configured speculation depth (--consolidation-frontier-depth),
    floored at 1 — depth 1 IS the sequential probe order, still riding the
    shared frontier context."""
    from karpenter_tpu_torch.ops import frontier as ftr

    return max(
        1,
        int(
            getattr(
                c.provisioner.options,
                "consolidation_frontier_depth",
                ftr.DEFAULT_DEPTH,
            )
        ),
    )


# frontier-search telemetry: a "round" is one coalesced simulate batch, a
# "probe" one prefix simulation inside it. rounds x batch-size vs the
# sequential log2(N) is the whole point — these are the series that prove it
_FRONTIER_ROUNDS = global_registry.histogram(
    "karpenter_consolidation_frontier_rounds",
    "coalesced simulate-batch rounds per consolidation compute",
    labels=["consolidation_type"],
    buckets=(1, 2, 3, 4, 6, 8, 12, 16),
)
_FRONTIER_PROBES = global_registry.counter(
    "karpenter_consolidation_frontier_probes_total",
    "prefix/candidate probes simulated by the consolidation frontier search",
    labels=["consolidation_type"],
)
_FRONTIER_BATCH_SIZE = global_registry.histogram(
    "karpenter_consolidation_frontier_batch_size",
    "probes per coalesced frontier round",
    labels=["consolidation_type"],
    buckets=(1, 2, 3, 7, 15, 31, 63),
)


class Emptiness:
    """Delete nodes with no reschedulable pods (emptiness.go)."""

    def __init__(self, c: Consolidation, validator=None):
        self.c = c
        self.validator = validator or EmptinessValidator(c)

    def reason(self) -> str:
        return DISRUPTION_REASON_EMPTY

    def disruption_class(self) -> str:
        return GRACEFUL_DISRUPTION_CLASS

    def consolidation_type(self) -> str:
        return "empty"

    def should_disrupt(self, candidate: Candidate) -> bool:
        if candidate.node_pool.spec.disruption.consolidate_after is None:
            self.c._unconsolidatable(candidate, "NodePool has consolidation disabled")
            return False
        from karpenter_tpu_torch.apis.nodeclaim import CONDITION_CONSOLIDATABLE

        return not candidate.reschedulable_pods and candidate.node_claim.condition_is_true(
            CONDITION_CONSOLIDATABLE
        )

    def compute_command(self, budgets: dict[str, int], *candidates: Candidate) -> Command:
        # defensive copy: budgets decrement as empties are admitted; the
        # caller's mapping must survive a retry of the same pass untouched
        budgets = dict(budgets)
        if self.c.is_consolidated():
            return Command()
        candidates = self.c.sort_candidates(list(candidates))
        empty = []
        constrained = False
        for candidate in candidates:
            if candidate.reschedulable_pods:
                continue
            if budgets.get(candidate.node_pool.metadata.name, 0) == 0:
                constrained = True
                continue
            empty.append(candidate)
            budgets[candidate.node_pool.metadata.name] -= 1
        if not empty:
            if not constrained:
                self.c.mark_consolidated()
            return Command()
        # Unvalidated: the disruption controller holds the command for
        # CONSOLIDATION_TTL and runs self.validator on a later pass.
        return Command(candidates=empty)


class Drift:
    """Replace NodeClaims whose Drifted condition is true, oldest-drift first
    (drift.go:52-111)."""

    def __init__(self, store, cluster, provisioner, recorder):
        self.store = store
        self.cluster = cluster
        self.provisioner = provisioner
        self.recorder = recorder

    def reason(self) -> str:
        return DISRUPTION_REASON_DRIFTED

    def disruption_class(self) -> str:
        return EVENTUAL_DISRUPTION_CLASS

    def consolidation_type(self) -> str:
        return ""

    def should_disrupt(self, candidate: Candidate) -> bool:
        return candidate.node_claim.condition_is_true(self.reason())

    def node_prefilter(self, node) -> bool:
        """Drift is decidable from the claim condition alone — skip the full
        candidate build (PDB walks, cost model) for the typical cluster
        where nothing has drifted. Strict superset of should_disrupt."""
        return node.node_claim is not None and node.node_claim.condition_is_true(
            self.reason()
        )

    def compute_command(self, budgets: dict[str, int], *candidates: Candidate) -> Command:
        def drift_time(c: Candidate) -> float:
            cond = c.node_claim.get_condition(self.reason())
            return cond.last_transition_time if cond else 0.0

        for candidate in sorted(candidates, key=drift_time):
            if not candidate.reschedulable_pods:
                continue
            if budgets.get(candidate.node_pool.metadata.name, 0) == 0:
                continue
            try:
                results = simulate_scheduling(
                    self.store, self.cluster, self.provisioner, candidate
                )
            except CandidateDeletingError:
                continue
            if not results.all_non_pending_pods_scheduled():
                self.recorder.publish(
                    Event(
                        candidate.node_claim,
                        "Normal",
                        "DisruptionBlocked",
                        results.non_pending_pod_scheduling_errors(),
                    )
                )
                continue
            return Command(
                candidates=[candidate],
                replacements=replacements_from_node_claims(results.new_node_claims),
                results=results,
            )
        return Command()


class MultiNodeConsolidation:
    """Binary search for the largest simultaneously-consolidatable prefix of
    the ≤100 cheapest-to-disrupt candidates (multinodeconsolidation.go)."""

    def __init__(self, c: Consolidation, validator=None):
        self.c = c
        self.validator = validator or ConsolidationValidator(c, self, "multi")

    def reason(self) -> str:
        return DISRUPTION_REASON_UNDERUTILIZED

    def disruption_class(self) -> str:
        return GRACEFUL_DISRUPTION_CLASS

    def consolidation_type(self) -> str:
        return "multi"

    def should_disrupt(self, candidate: Candidate) -> bool:
        return self.c.should_disrupt(candidate)

    def compute_command(self, budgets: dict[str, int], *candidates: Candidate) -> Command:
        # defensive copy: the filter below decrements per-pool budgets as it
        # admits candidates, and the caller's mapping must stay pristine —
        # a shed/timeout retry of the same pass re-enters with the SAME dict
        # and would otherwise see pre-decremented budgets
        budgets = dict(budgets)
        if self.c.is_consolidated():
            return Command()
        candidates = self.c.sort_candidates(list(candidates))
        disruptable = []
        constrained = False
        for candidate in candidates:
            if budgets.get(candidate.node_pool.metadata.name, 0) == 0:
                constrained = True
                continue
            if not candidate.reschedulable_pods:
                continue
            disruptable.append(candidate)
            budgets[candidate.node_pool.metadata.name] -= 1
        max_parallel = min(len(disruptable), MAX_PARALLEL_CONSOLIDATION)
        cmd = self._first_n_consolidation_option(disruptable, max_parallel)
        if cmd.decision() == DECISION_NOOP:
            if not constrained:
                self.c.mark_consolidated()
            return cmd
        # Unvalidated: two-phase validation happens in the controller.
        return cmd

    def _first_n_consolidation_option(
        self, candidates: list[Candidate], max_n: int
    ) -> Command:
        """The device-resident frontier search. Each round evaluates every
        probe the sequential binary search (_first_n_sequential, the
        reference port and parity oracle) could visit in its next `depth`
        verdicts — one speculative level-set of its decision tree — as ONE
        frontier-tagged solverd batch: the coalescer fuses the k prefix
        simulations' joint-mask sweeps into a single device pass primed from
        the largest prefix, and every probe's scheduler stamps from the
        round's shared cluster view (FrontierSimulator) instead of
        rebuilding it. The host then walks `depth` verdicts of the tree,
        updating (lo, hi, last_saved) exactly as the sequential loop would —
        the probe set being the decision tree's own level-set is what makes
        the walk reproduce the sequential search's probe sequence, and
        therefore its decision, bit for bit with no monotonicity assumption.
        Rounds: ceil(log2(N)/depth) batches instead of log2(N) sequential
        simulations. Per-prefix candidate prices and the
        replace-cheaper-than-cheapest gate come from the prefix reductions
        (ops/frontier) computed once per compute instead of once per probe."""
        if len(candidates) < 2:
            return Command()
        from karpenter_tpu_torch.ops import frontier as ftr

        depth = _frontier_depth(self.c)
        sim = FrontierSimulator(self.c.store, self.c.cluster, self.c.provisioner)
        prices = ftr.PrefixPrices(candidates)
        floors = ftr.PrefixTypeFloors(candidates)
        lo_n, hi_n = 1, min(max_n, len(candidates) - 1)
        last_saved = Command()
        deadline = self.c.clock.now() + MULTI_NODE_CONSOLIDATION_TIMEOUT
        tracer = tracing.tracer()
        rounds = 0
        while lo_n <= hi_n:
            # the 60s cap holds between frontier rounds: a mid-search
            # timeout returns the best command validated so far, exactly
            # like the sequential loop's per-probe check
            if self.c.clock.now() > deadline:
                _CONSOLIDATION_TIMEOUTS.inc({"consolidation_type": "multi"})
                _slo_deadline(bad=1)
                if rounds:
                    _FRONTIER_ROUNDS.observe(
                        float(rounds), {"consolidation_type": "multi"}
                    )
                return last_saved
            rounds += 1
            probes = ftr.speculative_probes(lo_n, hi_n, depth)
            with tracer.span(
                "consolidation.frontier",
                consolidation_type="multi",
                round=rounds,
                lo=lo_n,
                hi=hi_n,
                probes=len(probes),
            ) as span:
                fused0 = fused_mod.FUSED_SOLVES
                plans = {mid: sim.plan(candidates[: mid + 1]) for mid in probes}
                sim.solve_batch(list(plans.values()))
                # probe levels riding the one-dispatch scan: with the fused
                # path on, each prefix sim is ONE device dispatch instead of
                # a host-paced sweep conversation (process-history attr)
                span.set_volatile(fused_probes=fused_mod.FUSED_SOLVES - fused0)
            _FRONTIER_PROBES.inc(
                {"consolidation_type": "multi"}, float(len(probes))
            )
            _FRONTIER_BATCH_SIZE.observe(
                float(len(probes)), {"consolidation_type": "multi"}
            )
            for _ in range(depth):
                if lo_n > hi_n:
                    break
                mid = (lo_n + hi_n) // 2
                cmd = self._probe_verdict(plans[mid], candidates, mid, prices)
                ok = cmd.decision() == DECISION_DELETE
                if cmd.decision() == DECISION_REPLACE:
                    ok = self._replace_gate(cmd, mid, floors)
                if ok:
                    last_saved = cmd
                    lo_n = mid + 1
                else:
                    hi_n = mid - 1
        _FRONTIER_ROUNDS.observe(float(rounds), {"consolidation_type": "multi"})
        _slo_deadline(good=1)
        return last_saved

    def _probe_verdict(self, plan, candidates, mid, prices) -> Command:
        """One walked probe's Command. Errors surface with sequential
        semantics: a deleting candidate is a no-op Command
        (compute_consolidation's CandidateDeletingError catch); anything
        else — solver rejection, transport failure — raises, but only for
        probes the walk actually reaches, since the sequential search never
        ran the speculative ones."""
        # port: a KernelError never reaches here — FrontierSimulator
        # .solve_batch raised it for the whole round before the walk
        if isinstance(plan.error, CandidateDeletingError):
            return Command()
        if plan.error is not None:
            raise plan.error
        return self.c.consolidation_decision(
            candidates[: mid + 1],
            plan.results,
            candidate_price=prices.for_prefix(mid + 1),
        )

    @staticmethod
    def _replace_gate(cmd: Command, mid: int, floors) -> bool:
        """The replace-cheaper-than-cheapest price gate with the prefix
        reduction's per-type floors standing in for _filter_out_same_type's
        per-probe rescan — byte-identical verdicts (same price cap, same
        remove call), O(1) per probe after the one-pass reduction."""
        replacement = cmd.replacements[0]
        max_price = floors.max_price(
            mid + 1,
            [it.name for it in replacement.node_claim.instance_type_options],
        )
        try:
            replacement.node_claim.remove_instance_type_options_by_price_and_min_values(
                replacement.node_claim.requirements, max_price
            )
        except ValueError:
            return False
        return bool(replacement.node_claim.instance_type_options)

    def _first_n_sequential(
        self, candidates: list[Candidate], max_n: int
    ) -> Command:
        """multinodeconsolidation.go:117-170 — the reference's sequential
        binary search, verbatim: one full scheduling simulation per probe,
        each bound waiting on the last verdict. Kept as the parity oracle
        the frontier search is fuzzed against (tests/test_frontier.py): the
        frontier must select the same command on every seeded candidate
        set."""
        if len(candidates) < 2:
            return Command()
        lo_n, hi_n = 1, min(max_n, len(candidates) - 1)
        last_saved = Command()
        deadline = self.c.clock.now() + MULTI_NODE_CONSOLIDATION_TIMEOUT
        while lo_n <= hi_n:
            if self.c.clock.now() > deadline:
                _CONSOLIDATION_TIMEOUTS.inc({"consolidation_type": "multi"})
                _slo_deadline(bad=1)
                return last_saved
            mid = (lo_n + hi_n) // 2
            prefix = candidates[: mid + 1]
            cmd = self.c.compute_consolidation(*prefix)
            ok = cmd.decision() == DECISION_DELETE
            if cmd.decision() == DECISION_REPLACE:
                try:
                    _filter_out_same_type(cmd.replacements[0], prefix)
                    ok = bool(cmd.replacements[0].node_claim.instance_type_options)
                except ValueError:
                    ok = False
            if ok:
                last_saved = cmd
                lo_n = mid + 1
            else:
                hi_n = mid - 1
        _slo_deadline(good=1)
        return last_saved


def _filter_out_same_type(replacement, consolidate: list[Candidate]) -> None:
    """Replacement must be cheaper than the cheapest current price of any
    shared instance type, or it would flap (multinodeconsolidation.go:188-226)."""
    existing_types = set()
    prices_by_type: dict[str, float] = {}
    for c in consolidate:
        existing_types.add(c.instance_type.name)
        from karpenter_tpu_torch.cloudprovider.types import Offerings

        compatible = Offerings(c.instance_type.offerings).compatible(
            Requirements.from_labels(c.state_node.labels())
        )
        if not compatible:
            continue
        p = compatible.cheapest().price
        if p < prices_by_type.get(c.instance_type.name, math.inf):
            prices_by_type[c.instance_type.name] = p
    max_price = math.inf
    for it in replacement.node_claim.instance_type_options:
        if it.name in existing_types:
            max_price = min(max_price, prices_by_type.get(it.name, math.inf))
    replacement.node_claim.remove_instance_type_options_by_price_and_min_values(
        replacement.node_claim.requirements, max_price
    )


class SingleNodeConsolidation:
    """One candidate at a time, cheapest-disruption-first with nodepool
    fairness across timeouts (singlenodeconsolidation.go)."""

    def __init__(self, c: Consolidation, validator=None):
        self.c = c
        self.validator = validator or ConsolidationValidator(c, self, "single")
        self.previously_unseen_nodepools: set[str] = set()

    def reason(self) -> str:
        return DISRUPTION_REASON_UNDERUTILIZED

    def disruption_class(self) -> str:
        return GRACEFUL_DISRUPTION_CLASS

    def consolidation_type(self) -> str:
        return "single"

    def should_disrupt(self, candidate: Candidate) -> bool:
        return self.c.should_disrupt(candidate)

    def compute_command(self, budgets: dict[str, int], *candidates: Candidate) -> Command:
        """The cheapest-first walk, with the per-candidate simulations run
        as speculative look-ahead chunks through the frontier batch path:
        the next w sim-eligible candidates simulate as ONE coalesced solverd
        group, then the walk consumes verdicts in candidate order and
        returns at the first non-noop exactly like the sequential loop.
        Verdict events (single-candidate Unconsolidatable messages) are
        DEFERRED at simulation time and published only for candidates the
        walk actually reaches — a speculative probe past the winner must
        leave no trace in the event stream."""
        # defensive copy (same contract as MultiNodeConsolidation): the
        # caller's budget mapping survives this pass untouched
        budgets = dict(budgets)
        if self.c.is_consolidated():
            return Command()
        candidates = self.sort_candidates(list(candidates))
        deadline = self.c.clock.now() + SINGLE_NODE_CONSOLIDATION_TIMEOUT
        constrained = False
        unseen = {c.node_pool.metadata.name for c in candidates}
        sim: Optional[FrontierSimulator] = None
        tracer = tracing.tracer()
        width = (1 << _frontier_depth(self.c)) - 1
        # candidate index -> (command, deferred events, error)
        verdicts: dict[int, tuple] = {}
        rounds = 0

        def eligible(c: Candidate) -> bool:
            return (
                budgets.get(c.node_pool.metadata.name, 0) != 0
                and bool(c.reschedulable_pods)
            )

        def ensure_verdict(start: int) -> None:
            nonlocal sim, rounds
            batch = []
            for j in range(start, len(candidates)):
                if len(batch) >= width:
                    break
                if j not in verdicts and eligible(candidates[j]):
                    batch.append(j)
            if not batch:
                return
            if sim is None:
                sim = FrontierSimulator(
                    self.c.store, self.c.cluster, self.c.provisioner
                )
            rounds += 1
            with tracer.span(
                "consolidation.frontier",
                consolidation_type="single",
                round=rounds,
                probes=len(batch),
            ) as span:
                fused0 = fused_mod.FUSED_SOLVES
                plans = {j: sim.plan([candidates[j]]) for j in batch}
                # disjoint candidates, not nested prefixes: every member's
                # row-sets must be collected for the shared prime
                sim.solve_batch(list(plans.values()), nested=False)
                span.set_volatile(fused_probes=fused_mod.FUSED_SOLVES - fused0)
            _FRONTIER_PROBES.inc(
                {"consolidation_type": "single"}, float(len(batch))
            )
            _FRONTIER_BATCH_SIZE.observe(
                float(len(batch)), {"consolidation_type": "single"}
            )
            for j, plan in plans.items():
                if isinstance(plan.error, CandidateDeletingError):
                    verdicts[j] = (Command(), [], None)
                elif plan.error is not None:
                    verdicts[j] = (None, [], plan.error)
                else:
                    events: list = []
                    cmd = self.c.consolidation_decision(
                        [candidates[j]], plan.results, events=events
                    )
                    verdicts[j] = (cmd, events, None)

        try:
            for i, candidate in enumerate(candidates):
                if self.c.clock.now() > deadline:
                    _CONSOLIDATION_TIMEOUTS.inc({"consolidation_type": "single"})
                    _slo_deadline(bad=1)
                    self.previously_unseen_nodepools = unseen
                    return Command()
                unseen.discard(candidate.node_pool.metadata.name)
                if budgets.get(candidate.node_pool.metadata.name, 0) == 0:
                    constrained = True
                    continue
                if not candidate.reschedulable_pods:
                    continue
                if i not in verdicts:
                    ensure_verdict(i)
                cmd, events, error = verdicts.pop(i)
                for target, message in events:
                    self.c._unconsolidatable(target, message)
                if error is not None:
                    # surfaced only when the walk reaches it — sequential
                    # semantics (the speculative siblings never ran there);
                    # port: a KernelError was raised for the whole round by
                    # FrontierSimulator.solve_batch before this walk
                    raise error
                if cmd.decision() == DECISION_NOOP:
                    continue
                # Unvalidated: two-phase validation happens in the controller.
                _slo_deadline(good=1)
                return cmd
            if not constrained:
                self.c.mark_consolidated()
            self.previously_unseen_nodepools = unseen
            _slo_deadline(good=1)
            return Command()
        finally:
            if rounds:
                _FRONTIER_ROUNDS.observe(
                    float(rounds), {"consolidation_type": "single"}
                )

    def sort_candidates(self, candidates: list[Candidate]) -> list[Candidate]:
        """Cost-sorted, round-robin interleaved across nodepools with unseen
        pools first (singlenodeconsolidation.go:122-150)."""
        candidates = sorted(candidates, key=lambda c: c.disruption_cost)
        by_pool: dict[str, list[Candidate]] = {}
        for c in candidates:
            by_pool.setdefault(c.node_pool.metadata.name, []).append(c)
        pools = sorted(self.previously_unseen_nodepools & set(by_pool)) + sorted(
            set(by_pool) - self.previously_unseen_nodepools
        )
        result = []
        longest = max((len(v) for v in by_pool.values()), default=0)
        for i in range(longest):
            for pool in pools:
                if i < len(by_pool[pool]):
                    result.append(by_pool[pool][i])
        return result
