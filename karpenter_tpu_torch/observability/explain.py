"""Decision provenance observatory: per-pod elimination ledgers.

The solver collapses every (pod x instance-type x nodepool) decision into
one coarse error string. This module keeps the provenance: while a solve
runs, the scheduler's per-nodepool failures are *staged* against the pod's
uid (``note_funnel``), and when the solve commits (solverd coalescer,
KIND_SOLVE only) each still-unschedulable pod folds its staged funnel into
a bounded, ring-buffered **elimination ledger** entry — the stage-by-stage
story of why no nodepool could host it. Pods that placed drop their
staging; simulation solves (consolidation probes) never commit.

Stage vocabulary (``STAGES``): the interned reason set every error string
or typed exception classifies into (``classify``). The feasibility cube's
per-stage masks are decoded into the same vocabulary by the stage-plane
helpers in ``ops/feasibility.py`` (requirements -> resources -> offerings,
first-failing-stage attribution) and feed
``karpenter_explain_eliminations_total{stage}``; the fused scan's decline
taxonomy folds in as dynamic ``fused:<reason>`` stages so fused and host
paths tell one story.

Determinism contract (the flight-recorder discipline): the ledger holds
scenario facts only — pod identity, virtual-clock time, stage names,
error strings — never wall measurements. ``report()`` digests the ring
(sha256 over canonical JSON lines), so same-seed sim runs produce
byte-identical ledgers; ``sampled`` mode draws from a hash of the pod uid
(uids ride the injected seeded source), never from a wall clock.

Surfaces: ``/debug/explain`` (triage table; ``?pod=`` drill-down;
``?what_if=drop:<key>`` counterfactual probe routed through the solverd
coalescer as a simulate-kind request — deadline-bounded, never the
serving hot path), the unschedulable-pod Warning events (top-3 reasons),
per-solve span attrs, and the sim's ``report["explain"]`` section.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import deque
from typing import Optional, Sequence

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.utils.clock import Clock

_ELIMS = global_registry.counter(
    "karpenter_explain_eliminations_total",
    "per-stage elimination attributions recorded by the provenance ledger",
    labels=["stage"],
)
_COMMITS = global_registry.counter(
    "karpenter_explain_pods_total",
    "unschedulable-pod ledger entries committed, by capture mode",
    labels=["mode"],
)
_RING_DEPTH = global_registry.gauge(
    "karpenter_explain_ring_depth",
    "ledger entries currently held in the explanation ring",
)
_PROBES = global_registry.counter(
    "karpenter_explain_probes_total",
    "counterfactual what-if probes served, by outcome",
    labels=["outcome"],
)
_FUNNEL_STAGES = global_registry.histogram(
    "karpenter_explain_funnel_stages",
    "distinct eliminating stages per committed ledger entry",
    buckets=(1.0, 2.0, 3.0, 5.0, 8.0),
)

# The interned stage vocabulary, funnel order: the order a pod's candidacy
# is whittled down on the serving path (NodeClaim.can_add gate order, then
# the catalog triple, then post-filter gates). Dynamic `fused:<reason>`
# stages extend it with the one-dispatch scan's decline taxonomy.
STAGES = (
    "taints",
    "host-ports",
    "requirements",
    "topology",
    "limits",
    "resources",
    "offerings",
    "min-values",
    "reserved",
    "timeout",
    "no-nodepools",
    "unknown",
)

# Ordered message rules for errors that only exist as strings (the host
# error assembly joins per-nodepool parts with "; "). First match wins
# within a part; parts classify independently.
_MESSAGE_RULES = (
    ("checking host port usage", "host-ports"),
    ("incompatible requirements", "requirements"),
    ("exceed limits for nodepool", "limits"),
    ("nodepool requirements filtered out", "requirements"),
    ("minvalues", "min-values"),
    ("tolerate", "taints"),
    ("taint", "taints"),
    ("topology", "topology"),
    ("spread", "topology"),
    ("no nodepools found", "no-nodepools"),
    ("timed out", "timeout"),
    ("reserved", "reserved"),
    ("scheduling requirements", "requirements"),
    ("enough resources", "resources"),
    ("required offering", "offerings"),
    ("requirements", "requirements"),
)


def classify(err) -> tuple[str, ...]:
    """Map one scheduling error (typed exception or string-shaped) to its
    eliminating stage(s) from STAGES, funnel-ordered."""
    from karpenter_tpu_torch.scheduler.nodeclaim import (
        InstanceTypeFilterError,
        ReservedOfferingError,
    )

    if isinstance(err, TimeoutError):
        return ("timeout",)
    if isinstance(err, ReservedOfferingError):
        return ("reserved",)
    if isinstance(err, InstanceTypeFilterError):
        if err.min_values_incompatible is not None:
            return ("min-values",)
        stages = []
        if not err.requirements_met:
            stages.append("requirements")
        if not err.fits:
            stages.append("resources")
        if not err.has_offering:
            stages.append("offerings")
        if stages:
            return tuple(stages)
        # every criterion is individually satisfiable; the named pairwise
        # intersection is what emptied the set — blame the third criterion
        if err.requirements_and_fits:
            return ("offerings",)
        if err.fits_and_offering:
            return ("requirements",)
        if err.requirements_and_offering:
            return ("resources",)
        return ("unknown",)
    return classify_message(str(err))


def classify_message(message: str) -> tuple[str, ...]:
    """Classify a string-shaped error; "; "-joined multi-nodepool
    aggregates classify per part, deduplicated in funnel order."""
    stages: list[str] = []
    for part in message.split("; "):
        low = part.lower()
        for needle, stage in _MESSAGE_RULES:
            if needle in low:
                if stage not in stages:
                    stages.append(stage)
                break
        else:
            if "unknown" not in stages:
                stages.append("unknown")
    return tuple(sorted(stages, key=_stage_order))


def _stage_order(stage: str) -> int:
    try:
        return STAGES.index(stage)
    except ValueError:
        return len(STAGES)  # fused:<reason> and future dynamic stages


def funnel_from(pool_errs: Sequence[tuple]) -> list[dict]:
    """Build the staged per-nodepool funnel from (nodepool, error) pairs —
    the scheduler's template-order walk, one record per attempted pool."""
    return [
        {
            "nodepool": pool or "*",
            "stages": list(classify(err)),
            "error": str(err),
        }
        for pool, err in pool_errs
    ]


def canonical(entry: dict) -> str:
    return json.dumps(entry, sort_keys=True, separators=(",", ":"))


class ExplainRecorder:
    """Process-global elimination ledger (module accessor: ``recorder()``).

    Modes: ``""``/``"off"`` — disabled, every capture hook is a cheap
    early-return (the default; nothing on the solve path changes);
    ``"on"`` — every unschedulable pod commits a ledger entry;
    ``"sampled"`` — a deterministic ~25% of pods commit, drawn from a
    sha256 of the pod uid (seeded uid source => same-seed determinism).
    """

    def __init__(self, clock: Optional[Clock] = None, capacity: int = 256):
        self._lock = threading.Lock()
        self.clock = clock or Clock()
        self.mode = ""
        self.capacity = capacity
        self._ring: deque = deque(maxlen=max(1, capacity))  # uids, FIFO
        self._entries: dict[str, dict] = {}
        # funnels staged mid-solve, keyed by pod uid; bounded independently
        # of the ring so direct Scheduler.solve callers that never commit
        # (unit tests, parity harnesses) cannot grow it without bound
        self._staged: dict[str, list[dict]] = {}
        self._committed = 0
        self._evicted = 0
        self._fused: dict[str, int] = {}

    # -- configuration -------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self.mode in ("on", "sampled")

    def configure(
        self,
        clock: Optional[Clock] = None,
        mode: Optional[str] = None,
        capacity: Optional[int] = None,
    ) -> "ExplainRecorder":
        with self._lock:
            if clock is not None:
                self.clock = clock
            if mode is not None:
                self.mode = "" if mode == "off" else mode
            if capacity is not None and capacity != self.capacity:
                self.capacity = capacity
                self._ring = deque(self._ring, maxlen=max(1, capacity))
        return self

    def reset(self) -> None:
        """Drop ledger state (sim run start); mode, clock, and capacity
        survive — the flight-recorder reset contract."""
        with self._lock:
            self._ring.clear()
            self._entries.clear()
            self._staged.clear()
            self._committed = 0
            self._evicted = 0
            self._fused.clear()
        _RING_DEPTH.set(0.0)

    # -- capture hooks (solve path; cheap no-ops when disabled) --------------

    def want(self, uid: str) -> bool:
        """Would this pod commit an entry? ``sampled`` draws ~1 in 4 from a
        hash of the uid — uids ride the injected seeded source, so the
        sample is a pure function of the scenario seed."""
        if self.mode == "on":
            return True
        if self.mode == "sampled":
            return hashlib.sha256(uid.encode()).digest()[0] < 64
        return False

    def note_funnel(self, uid: str, funnel: list[dict]) -> None:
        """Stage a pod's per-nodepool elimination funnel (the scheduler's
        template walk). Last write wins: the relaxation loop re-attempts a
        pod, and the final attempt is the one the final error describes."""
        if not self.enabled:
            return
        with self._lock:
            self._staged.pop(uid, None)
            self._staged[uid] = funnel
            while len(self._staged) > 4 * self.capacity:
                self._staged.pop(next(iter(self._staged)))

    def note_plane_counts(self, counts: dict[str, int]) -> None:
        """Fold first-failing-stage elimination counts decoded from the
        feasibility cube's stage plane (ops/feasibility.stage_plane) into
        the stage metric."""
        if not self.enabled:
            return
        for stage, n in counts.items():
            if n:
                _ELIMS.inc({"stage": stage}, value=float(n))

    def note_fused_decline(self, reason: str) -> None:
        """Fold the one-dispatch scan's decline taxonomy into the ledger as
        a dynamic ``fused:<reason>`` stage (solve-level: a decline reroutes
        the whole batch to the host walk, whose per-pod errors then stage
        normally — explanations stay path-identical)."""
        if not self.enabled:
            return
        with self._lock:
            self._fused[reason] = self._fused.get(reason, 0) + 1
        _ELIMS.inc({"stage": f"fused:{reason}"})

    def commit_solve(self, pods, pod_errors: dict, kind: str = "solve") -> None:
        """Solve-completion barrier (solverd coalescer): commit a ledger
        entry per still-unschedulable pod, drop staging for everyone else.
        Simulation-kind solves only clear staging — consolidation probes
        must not pollute the unschedulable-pod triage table."""
        if not self.enabled:
            return
        failed = {p.metadata.uid: (p, e) for p, e in pod_errors.items()}
        for pod in pods:
            uid = pod.metadata.uid
            if kind == "solve" and uid in failed:
                self._commit(*failed[uid])
            else:
                with self._lock:
                    self._staged.pop(uid, None)

    def _commit(self, pod, err) -> None:
        uid = pod.metadata.uid
        if not self.want(uid):
            with self._lock:
                self._staged.pop(uid, None)
            return
        stages = list(classify(err))
        with self._lock:
            funnel = self._staged.pop(uid, [])
            prior = self._entries.get(uid)
            entry = {
                "uid": uid,
                "pod": pod.metadata.name,
                "namespace": pod.metadata.namespace,
                "t": round(self.clock.now(), 6),
                "solves": (prior["solves"] + 1) if prior else 1,
                "error": str(err),
                "stages": stages,
                "funnel": funnel,
            }
            if prior is None:
                if len(self._ring) == self._ring.maxlen:
                    oldest = self._ring[0]
                    self._entries.pop(oldest, None)
                    self._evicted += 1
                self._ring.append(uid)
            else:
                # refresh recency: re-failing pods outlive one ring lap
                self._ring.remove(uid)
                self._ring.append(uid)
            self._entries[uid] = entry
            self._committed += 1
            depth = len(self._ring)
        _COMMITS.inc({"mode": self.mode})
        distinct = {s for f in funnel for s in f["stages"]} | set(stages)
        _FUNNEL_STAGES.observe(float(len(distinct)))
        for stage in sorted(distinct, key=_stage_order):
            _ELIMS.inc({"stage": stage})
        _RING_DEPTH.set(float(depth))

    # -- consumers -----------------------------------------------------------

    def top_reasons(self, uid: str, k: int = 3) -> list[str]:
        """The pod's top-k eliminating reasons as `stage(nodepool)` strings,
        funnel-ordered — the event-message enrichment."""
        with self._lock:
            entry = self._entries.get(uid)
            if entry is None:
                return []
            reasons: list[str] = []
            for f in entry["funnel"]:
                for stage in f["stages"]:
                    r = f"{stage}({f['nodepool']})"
                    if r not in reasons:
                        reasons.append(r)
            for stage in entry["stages"]:
                if not any(r.startswith(stage + "(") for r in reasons):
                    reasons.append(stage)
            return reasons[:k]

    def entry(self, pod: str) -> Optional[dict]:
        """Lookup by uid or by [namespace/]name (newest wins on name
        collisions — uids never collide)."""
        with self._lock:
            hit = self._entries.get(pod)
            if hit is not None:
                return dict(hit)
            for uid in reversed(self._ring):
                e = self._entries[uid]
                if e["pod"] == pod or f"{e['namespace']}/{e['pod']}" == pod:
                    return dict(e)
        return None

    def snapshot(self, pod: Optional[str] = None) -> Optional[dict]:
        """/debug/explain: the unschedulable-pod triage table, or one pod's
        stage-by-stage drill-down (None for an unknown pod -> 404)."""
        if pod is not None:
            entry = self.entry(pod)
            if entry is None:
                return None
            with self._lock:
                entry["fused_declines"] = dict(sorted(self._fused.items()))
            return entry
        with self._lock:
            rows = [
                {
                    k: self._entries[uid][k]
                    for k in ("pod", "namespace", "uid", "t", "solves", "stages", "error")
                }
                for uid in reversed(self._ring)
            ]
            return {
                "mode": self.mode or "off",
                "capacity": self.capacity,
                "committed": self._committed,
                "evicted": self._evicted,
                "ring_depth": len(rows),
                "fused_declines": dict(sorted(self._fused.items())),
                "pods": rows[:64],
            }

    def counters(self) -> dict:
        """Per-solve span attribution deltas (volatile attrs only)."""
        with self._lock:
            return {
                "explain_committed": self._committed,
                "explain_staged": len(self._staged),
                "explain_ring_depth": len(self._ring),
            }

    def note_probe(self, outcome: str) -> None:
        _PROBES.inc({"outcome": outcome})

    def report(self) -> dict:
        """The sim's ``report["explain"]`` section: deterministic facts and
        a sha256 digest over the canonical ledger — the same-seed
        regression fingerprint."""
        with self._lock:
            entries = [self._entries[uid] for uid in self._ring]
            fused = dict(sorted(self._fused.items()))
            committed, evicted = self._committed, self._evicted
        digest = hashlib.sha256()
        for entry in entries:
            digest.update(canonical(entry).encode())
            digest.update(b"\n")
        return {
            "mode": self.mode or "off",
            "committed": committed,
            "evicted": evicted,
            "ring_depth": len(entries),
            "fused_declines": fused,
            "stage_totals": _stage_totals(entries),
            "digest": "sha256:" + digest.hexdigest(),
        }


def _stage_totals(entries: list[dict]) -> dict[str, int]:
    totals: dict[str, int] = {}
    for entry in entries:
        for stage in {s for f in entry["funnel"] for s in f["stages"]} | set(
            entry["stages"]
        ):
            totals[stage] = totals.get(stage, 0) + 1
    return dict(sorted(totals.items()))


def drop_requirement(pod, key: str) -> bool:
    """What-if mutation: strip every constraint on `key` from a (deep-copied)
    pod — node selector entry, required node-affinity expressions, and
    topology-spread constraints keyed on it. Returns whether anything was
    dropped (a no-op probe is a 404-shaped answer, not a solve)."""
    dropped = False
    spec = pod.spec
    if key in getattr(spec, "node_selector", {}):
        del spec.node_selector[key]
        dropped = True
    affinity = getattr(spec, "affinity", None)
    node_aff = getattr(affinity, "node_affinity", None) if affinity else None
    for term in getattr(node_aff, "required", []) or []:
        before = len(term.match_expressions)
        term.match_expressions = [
            e for e in term.match_expressions if e.get("key") != key
        ]
        dropped = dropped or len(term.match_expressions) != before
    constraints = getattr(spec, "topology_spread_constraints", None)
    if constraints:
        kept = [c for c in constraints if getattr(c, "topology_key", None) != key]
        if len(kept) != len(constraints):
            spec.topology_spread_constraints = kept
            dropped = True
    return dropped


_RECORDER = ExplainRecorder()


def recorder() -> ExplainRecorder:
    return _RECORDER


def configure(
    clock: Optional[Clock] = None,
    mode: Optional[str] = None,
    capacity: Optional[int] = None,
) -> ExplainRecorder:
    return _RECORDER.configure(clock=clock, mode=mode, capacity=capacity)
