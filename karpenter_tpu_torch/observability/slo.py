"""SLO burn-rate engine: declarative objectives evaluated as streaming
multi-window burn rates over the injected Clock.

Where the kernel observatory answers "what is the device doing" and
tracing answers "where did this request's time go", this module answers
the question production actually pages on: **are we meeting our
objectives, and how fast are we burning the error budget?** (Google SRE
workbook, "Alerting on SLOs": multiwindow, multi-burn-rate alerts.)

An ``SLOSpec`` declares a target compliance ratio and a set of evaluation
windows; instrumentation sites feed good/bad events (or raw latencies
classified by the spec's threshold) with optional per-tenant attribution —
the tenant tags PR 9 put on every SolveRequest ride straight through. The
engine maintains one streaming event series per (objective, tenant),
prunes it to the longest window, and on each ``evaluate(now)`` computes:

- **burn rate** per window: (bad/total within the window) / (1 - target) —
  how many times faster than the sustainable rate the budget is burning.
  A window whose burn rate crosses its threshold is *burning*; the
  transition in is edge-triggered and emits a typed ``SLOBreach`` to every
  subscriber (the operator publishes a Warning event and asks the flight
  recorder for a postmortem bundle; the simulator appends an event-log
  entry).
- **compliance ratio** (cumulative good/total) and **error-budget
  remaining** over the budget window (the longest window), per
  objective × tenant, exported as ``karpenter_slo_*`` gauge families.

Determinism contract (same as tracing/ and the kernel observatory): all
timestamps come from the injected Clock and evaluation runs once per
operator pass, so under FakeClock a sim run's breach stream, gauge values,
and ``report()`` digest are pure functions of (scenario, seed). Wall-clock
never enters the series.

Zero-tolerance objectives (``objective == 1.0``, e.g. "steady-state
recompiles == 0") have no budget: any bad event in a window is an
immediate breach (burn rate capped at ``BURN_CAP`` for display).

A hard breach — an ``availability=True`` objective burning in **all** its
windows at once (the SRE workbook's page condition) — degrades
``/healthz`` to 503; recovery of any window recovers the probe.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.utils.clock import Clock

_COMPLIANCE = global_registry.gauge(
    "karpenter_slo_compliance_ratio",
    "cumulative good/total event ratio per objective and tenant",
    labels=["objective", "tenant"],
)
_BURN_RATE = global_registry.gauge(
    "karpenter_slo_burn_rate",
    "error-budget burn rate per objective, tenant, and evaluation window "
    "(1.0 = exactly the sustainable rate)",
    labels=["objective", "tenant", "window"],
)
_BUDGET_REMAINING = global_registry.gauge(
    "karpenter_slo_error_budget_remaining",
    "fraction of the error budget left over the budget window (negative = "
    "overspent)",
    labels=["objective", "tenant"],
)
_EVENTS = global_registry.counter(
    "karpenter_slo_events_total",
    "SLO events recorded, by objective and outcome",
    labels=["objective", "outcome"],
)
_BREACHES = global_registry.counter(
    "karpenter_slo_breaches_total",
    "edge-triggered burn-rate breaches, by objective and window",
    labels=["objective", "window"],
)
_BREACH_DURATION = global_registry.histogram(
    "karpenter_slo_breach_duration_seconds",
    "how long a window stayed burning before it recovered",
    labels=["objective", "window"],
    buckets=(1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0, 1800.0),
)

# burn-rate display cap: zero-tolerance objectives have no budget, so any
# bad event is an "infinite" burn — capped so gauges and JSON stay finite
BURN_CAP = 1e6
# breach history kept for /debug/slo and report()
_BREACH_HISTORY = 50


@dataclass(frozen=True)
class Window:
    """One evaluation window: a lookback span and the burn-rate threshold
    past which it is *burning*. Fast windows (short span, high threshold)
    catch sharp regressions; slow windows (long span, low threshold) catch
    sustained slow burns the fast window forgets."""

    name: str
    seconds: float
    burn_threshold: float


@dataclass
class SLOSpec:
    """A declarative objective. ``objective`` is the target compliance
    ratio (0.99 = 1% error budget; 1.0 = zero tolerance). ``threshold_s``
    classifies raw latency observations fed through ``observe()``:
    value <= threshold is good. ``availability=True`` folds the objective
    into /healthz: burning in all windows at once = hard breach = 503."""

    name: str
    description: str
    objective: float
    windows: tuple = ()
    threshold_s: Optional[float] = None
    availability: bool = False

    def budget_window(self) -> Optional[Window]:
        return max(self.windows, key=lambda w: w.seconds) if self.windows else None


@dataclass(frozen=True)
class SLOBreach:
    """The typed breach record delivered to subscribers and kept in the
    engine's bounded history. All fields are deterministic under FakeClock."""

    objective: str
    tenant: str
    window: str
    burn_rate: float
    budget_remaining: float
    t: float

    def to_dict(self) -> dict:
        return {
            "objective": self.objective,
            "tenant": self.tenant,
            "window": self.window,
            "burn_rate": round(self.burn_rate, 6),
            "budget_remaining": round(self.budget_remaining, 6),
            "t": round(self.t, 6),
        }


def default_specs() -> list[SLOSpec]:
    """The serving path's built-in objective set. Windows are sized for
    both live operation and sim timescales (scenarios run 300-400 virtual
    seconds): fast = 60s at 14.4x burn, slow = 300s at 6x burn — the SRE
    workbook's 5m/1h pair scaled to the pass cadence."""
    fast = Window("fast", 60.0, 14.4)
    slow = Window("slow", 300.0, 6.0)
    return [
        SLOSpec(
            "pod-bind-latency",
            "pods bind within 60 virtual seconds of submission",
            objective=0.99,
            windows=(fast, slow),
            threshold_s=60.0,
        ),
        SLOSpec(
            "solve-latency",
            "solverd admit+solve journey stages complete within 1s",
            objective=0.99,
            windows=(fast, slow),
            threshold_s=1.0,
        ),
        SLOSpec(
            "solverd-availability",
            "solve requests are executed, not shed (operator-visible "
            "rejections count against the budget)",
            objective=0.99,
            windows=(fast, slow),
            availability=True,
        ),
        SLOSpec(
            "solverd-admission",
            "per-tenant admission: requests clear the queue/quota without "
            "being shed (rides the SolveRequest tenant tag)",
            objective=0.99,
            windows=(fast, slow),
        ),
        SLOSpec(
            "solverd-failover",
            "fleet solves complete without failing over off their routed "
            "replica",
            objective=0.99,
            windows=(fast, slow),
        ),
        SLOSpec(
            "steady-recompiles",
            "zero steady-state kernel recompiles (the sealed observatory "
            "contract)",
            objective=1.0,
            windows=(Window("steady", 300.0, 1.0),),
        ),
        SLOSpec(
            "consolidation-deadline",
            "consolidation computations finish inside their deadline",
            objective=1.0,
            windows=(Window("steady", 300.0, 1.0),),
        ),
    ]


def load_specs(selector: str) -> list[SLOSpec]:
    """Resolve --slo-specs: "default"/"" = the built-in set, "off" = no
    objectives (the engine records nothing), anything else = a JSON file of
    spec dicts (the same shape ``spec_to_dict`` writes)."""
    if selector in ("", "default"):
        return default_specs()
    if selector == "off":
        return []
    with open(selector, encoding="utf-8") as f:
        raw = json.load(f)
    specs = []
    for d in raw:
        specs.append(
            SLOSpec(
                name=d["name"],
                description=d.get("description", ""),
                objective=float(d["objective"]),
                windows=tuple(
                    Window(w["name"], float(w["seconds"]), float(w["burn_threshold"]))
                    for w in d.get("windows", [])
                ),
                threshold_s=d.get("threshold_s"),
                availability=bool(d.get("availability", False)),
            )
        )
    return specs


def spec_to_dict(spec: SLOSpec) -> dict:
    return {
        "name": spec.name,
        "description": spec.description,
        "objective": spec.objective,
        "windows": [
            {"name": w.name, "seconds": w.seconds, "burn_threshold": w.burn_threshold}
            for w in spec.windows
        ],
        "threshold_s": spec.threshold_s,
        "availability": spec.availability,
    }


class _Series:
    """One (objective, tenant) event stream: a deque of (t, good, bad)
    records pruned to the longest window, plus cumulative totals for the
    compliance ratio. Bounded by prune + the coalescing below."""

    __slots__ = ("events", "cum_good", "cum_bad")

    def __init__(self):
        self.events: deque = deque()
        self.cum_good = 0
        self.cum_bad = 0

    def record(self, t: float, good: int, bad: int) -> None:
        # coalesce same-timestamp records (many events per pass share one
        # virtual-time stamp) so the deque stays proportional to distinct
        # evaluation instants, not raw event volume
        if self.events and self.events[-1][0] == t:
            _, g, b = self.events[-1]
            self.events[-1] = (t, g + good, b + bad)
        else:
            self.events.append((t, good, bad))
        self.cum_good += good
        self.cum_bad += bad

    def prune(self, horizon: float) -> None:
        while self.events and self.events[0][0] < horizon:
            self.events.popleft()

    def window_counts(self, now: float, seconds: float) -> tuple[int, int]:
        horizon = now - seconds
        good = bad = 0
        for t, g, b in reversed(self.events):
            if t < horizon:
                break
            good += g
            bad += b
        return good, bad

    def compliance(self) -> float:
        total = self.cum_good + self.cum_bad
        return 1.0 if total == 0 else self.cum_good / total


def _burn_rate(good: int, bad: int, objective: float) -> float:
    total = good + bad
    if total == 0 or bad == 0:
        return 0.0
    budget = 1.0 - objective
    if budget <= 0.0:
        return BURN_CAP  # zero tolerance: any bad event is infinite burn
    return min(BURN_CAP, (bad / total) / budget)


def _budget_remaining(good: int, bad: int, objective: float) -> float:
    """Fraction of the window's error budget left: 1.0 untouched, 0.0
    exhausted, negative overspent. Zero-tolerance objectives report 1 or 0."""
    budget = 1.0 - objective
    total = good + bad
    if budget <= 0.0:
        return 0.0 if bad else 1.0
    if total == 0:
        return 1.0
    allowed = total * budget
    return max(-BURN_CAP, 1.0 - (bad / allowed))


class SLOEngine:
    """Process-global burn-rate evaluator (module accessor: ``engine()``)."""

    def __init__(self, clock: Optional[Clock] = None, specs=None):
        self._lock = threading.Lock()
        self.clock = clock or Clock()
        self._specs: dict[str, SLOSpec] = {}
        # (objective, tenant) -> _Series; tenant "" is the aggregate
        self._series: dict[tuple, _Series] = {}
        # (objective, tenant, window) -> burning-since t (absent = healthy)
        self._burning: dict[tuple, float] = {}
        # last evaluated burn rates, read by snapshots between evaluations
        self._last_burn: dict[tuple, float] = {}
        self._last_budget: dict[tuple, float] = {}
        self._last_eval_at: Optional[float] = None
        self._breaches: deque = deque(maxlen=_BREACH_HISTORY)
        self._breach_count = 0
        self._subscribers: dict[str, Callable[[SLOBreach], None]] = {}
        for spec in default_specs() if specs is None else specs:
            self._specs[spec.name] = spec

    # -- configuration -------------------------------------------------------

    def configure(self, clock: Optional[Clock] = None, specs=None) -> "SLOEngine":
        """Re-point the engine (a new Operator, a sim run). Replaces the
        spec set and clock and resets evaluation state; keyed subscribers
        persist (they replace themselves on re-registration)."""
        with self._lock:
            if clock is not None:
                self.clock = clock
            if specs is not None:
                self._specs = {spec.name: spec for spec in specs}
            self._reset_locked()
        return self

    def reset(self) -> None:
        """Drop all recorded state (sim run start); specs, clock, and
        subscribers survive."""
        with self._lock:
            self._reset_locked()

    def _reset_locked(self) -> None:
        self._series.clear()
        self._burning.clear()
        self._last_burn.clear()
        self._last_budget.clear()
        self._last_eval_at = None
        self._breaches.clear()
        self._breach_count = 0

    def subscribe(self, cb: Callable[[SLOBreach], None], key: str = "default") -> None:
        """Register a breach callback. Keyed replace semantics (same as the
        kernel registry's on_recompile): a rebuilt Operator or a new sim
        swaps its slot instead of accumulating dead callbacks."""
        with self._lock:
            self._subscribers[key] = cb

    def unsubscribe(self, key: str) -> None:
        """Release a subscriber slot (Operator.shutdown): keyed replace
        only helps when the next registrant reuses the SAME key — a
        differently-named operator would otherwise leave the old one
        resident in this process-global engine forever."""
        with self._lock:
            self._subscribers.pop(key, None)

    def specs(self) -> list[SLOSpec]:
        with self._lock:
            return list(self._specs.values())

    # -- recording -----------------------------------------------------------

    def record(
        self,
        objective: str,
        good: int = 0,
        bad: int = 0,
        tenant: str = "",
        now: Optional[float] = None,
    ) -> None:
        """Feed good/bad events. Records into the aggregate series ("")
        and, when a tenant is named, that tenant's series too."""
        with self._lock:
            spec = self._specs.get(objective)
            if spec is None or (good == 0 and bad == 0):
                return
            t = self.clock.now() if now is None else now
            self._series_for(objective, "").record(t, good, bad)
            if tenant:
                self._series_for(objective, tenant).record(t, good, bad)
        if good:
            _EVENTS.inc({"objective": objective, "outcome": "good"}, good)
        if bad:
            _EVENTS.inc({"objective": objective, "outcome": "bad"}, bad)

    def observe(
        self,
        objective: str,
        value: float,
        tenant: str = "",
        now: Optional[float] = None,
    ) -> None:
        """Feed a raw measurement (e.g. a latency); the spec's threshold_s
        classifies it. Specs without a threshold treat any observation as
        good — they are event-fed, not latency-fed."""
        spec = self._specs.get(objective)
        if spec is None:
            return
        good = spec.threshold_s is None or value <= spec.threshold_s
        self.record(
            objective, good=1 if good else 0, bad=0 if good else 1,
            tenant=tenant, now=now,
        )

    def _series_for(self, objective: str, tenant: str) -> _Series:
        key = (objective, tenant)
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = _Series()
        return series

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> list[SLOBreach]:
        """One evaluation pass: prune series, recompute burn rates and
        budgets, publish gauges, edge-trigger breaches. Called once per
        operator pass — under FakeClock the whole stream is deterministic.
        Returns the NEW breaches this evaluation produced."""
        new_breaches: list[SLOBreach] = []
        recovered: list[tuple] = []
        gauge_updates: list[tuple] = []
        with self._lock:
            t = self.clock.now() if now is None else now
            self._last_eval_at = t
            for (objective, tenant), series in self._series.items():
                spec = self._specs.get(objective)
                if spec is None or not spec.windows:
                    continue
                longest = max(w.seconds for w in spec.windows)
                series.prune(t - longest)
                budget_window = spec.budget_window()
                wg, wb = series.window_counts(t, budget_window.seconds)
                budget = _budget_remaining(wg, wb, spec.objective)
                self._last_budget[(objective, tenant)] = budget
                gauge_updates.append(
                    ("compliance", objective, tenant, None, series.compliance())
                )
                gauge_updates.append(
                    ("budget", objective, tenant, None, budget)
                )
                for window in spec.windows:
                    g, b = series.window_counts(t, window.seconds)
                    burn = _burn_rate(g, b, spec.objective)
                    key = (objective, tenant, window.name)
                    self._last_burn[key] = burn
                    gauge_updates.append(
                        ("burn", objective, tenant, window.name, burn)
                    )
                    burning = burn >= window.burn_threshold
                    was_burning = key in self._burning
                    if burning and not was_burning:
                        self._burning[key] = t
                        breach = SLOBreach(
                            objective=objective,
                            tenant=tenant,
                            window=window.name,
                            burn_rate=burn,
                            budget_remaining=budget,
                            t=t,
                        )
                        self._breaches.append(breach.to_dict())
                        self._breach_count += 1
                        new_breaches.append(breach)
                    elif not burning and was_burning:
                        recovered.append((key, t - self._burning.pop(key)))
            subscribers = tuple(self._subscribers.values())
        # metrics + callbacks outside the engine lock (they take their own)
        for kind, objective, tenant, window, value in gauge_updates:
            labels = {"objective": objective, "tenant": tenant}
            if kind == "compliance":
                _COMPLIANCE.set(value, labels)
            elif kind == "budget":
                _BUDGET_REMAINING.set(value, labels)
            else:
                labels["window"] = window
                _BURN_RATE.set(value, labels)
        for (objective, _tenant, window), duration in recovered:
            _BREACH_DURATION.observe(duration, {"objective": objective, "window": window})
        for breach in new_breaches:
            _BREACHES.inc({"objective": breach.objective, "window": breach.window})
            for cb in subscribers:
                try:
                    cb(breach)
                except Exception:  # noqa: BLE001 — observers never break the pass
                    pass
        return new_breaches

    # -- queries -------------------------------------------------------------

    def burning(self) -> list[dict]:
        """Currently-burning (objective, tenant, window) triples."""
        with self._lock:
            return [
                {
                    "objective": objective,
                    "tenant": tenant,
                    "window": window,
                    "since": round(since, 6),
                    "burn_rate": round(
                        self._last_burn.get((objective, tenant, window), 0.0), 6
                    ),
                }
                for (objective, tenant, window), since in sorted(self._burning.items())
            ]

    def hard_breached(self) -> list[str]:
        """Availability objectives burning in ALL their windows at once
        (aggregate tenant) — the /healthz 503 condition."""
        with self._lock:
            out = []
            for name, spec in self._specs.items():
                if not spec.availability or not spec.windows:
                    continue
                if all(
                    (name, "", w.name) in self._burning for w in spec.windows
                ):
                    out.append(name)
            return sorted(out)

    def worst_burning(self) -> Optional[dict]:
        """The objective with the highest last-evaluated aggregate burn
        rate, for the /healthz fold. None before any evaluation or when
        nothing has burned."""
        with self._lock:
            worst = None
            for (objective, tenant, window), burn in self._last_burn.items():
                if tenant != "" or burn <= 0.0:
                    continue
                if worst is None or burn > worst[1]:
                    worst = (objective, burn, window)
            if worst is None:
                return None
            objective, burn, window = worst
            return {
                "objective": objective,
                "window": window,
                "burn_rate": round(burn, 6),
                "error_budget_remaining": round(
                    self._last_budget.get((objective, ""), 1.0), 6
                ),
            }

    def _objective_entry(self, spec: SLOSpec, tenant: str) -> Optional[dict]:
        series = self._series.get((spec.name, tenant))
        if series is None:
            return None
        windows = {}
        for w in spec.windows:
            key = (spec.name, tenant, w.name)
            windows[w.name] = {
                "seconds": w.seconds,
                "burn_threshold": w.burn_threshold,
                "burn_rate": round(self._last_burn.get(key, 0.0), 6),
                "burning": key in self._burning,
            }
        return {
            "events": {"good": series.cum_good, "bad": series.cum_bad},
            "compliance": round(series.compliance(), 6),
            "error_budget_remaining": round(
                self._last_budget.get((spec.name, tenant), 1.0), 6
            ),
            "windows": windows,
        }

    def snapshot(
        self, objective: Optional[str] = None, tenant: Optional[str] = None
    ) -> Optional[dict]:
        """/debug/slo: the objective table, or one objective's per-tenant
        burn-rate drill-down (None for an unknown objective → 404)."""
        with self._lock:
            if objective is not None:
                spec = self._specs.get(objective)
                if spec is None:
                    return None
                tenants = sorted(
                    ten for (name, ten) in self._series if name == objective
                )
                out = {
                    "spec": spec_to_dict(spec),
                    "aggregate": self._objective_entry(spec, ""),
                    "tenants": {
                        ten: self._objective_entry(spec, ten)
                        for ten in tenants
                        if ten
                    },
                    "breaches": [
                        b for b in self._breaches if b["objective"] == objective
                    ],
                }
                if tenant is not None:
                    entry = self._objective_entry(spec, tenant)
                    if entry is None:
                        return None
                    out["tenant"] = {tenant: entry}
                return out
            objectives = {}
            for name, spec in sorted(self._specs.items()):
                entry = self._objective_entry(spec, "") or {
                    "events": {"good": 0, "bad": 0},
                    "compliance": 1.0,
                    "error_budget_remaining": 1.0,
                    "windows": {
                        w.name: {
                            "seconds": w.seconds,
                            "burn_threshold": w.burn_threshold,
                            "burn_rate": 0.0,
                            "burning": False,
                        }
                        for w in spec.windows
                    },
                }
                entry["description"] = spec.description
                entry["objective"] = spec.objective
                entry["availability"] = spec.availability
                objectives[name] = entry
            return {
                "objectives": objectives,
                "burning": [
                    {
                        "objective": obj,
                        "tenant": ten,
                        "window": win,
                        "since": round(since, 6),
                    }
                    for (obj, ten, win), since in sorted(self._burning.items())
                ],
                "breaches_total": self._breach_count,
                "last_breaches": list(self._breaches),
                "last_evaluated_at": self._last_eval_at,
            }

    def tenant_section(self, tenant: str) -> dict:
        """Per-tenant SLO section for the fleet report: every objective the
        tenant has events for, with burn/budget/compliance."""
        with self._lock:
            out = {}
            for name, spec in sorted(self._specs.items()):
                entry = self._objective_entry(spec, tenant)
                if entry is not None:
                    out[name] = entry
            return out

    def report(self) -> dict:
        """The sim's ``report["slo"]["objectives"]`` payload: deterministic
        per-objective (and per-tenant) facts plus the breach stream, with a
        sha256 digest over the canonical form — the same fingerprint
        discipline as the event log and span digests."""
        with self._lock:
            objectives: dict = {}
            for name, spec in sorted(self._specs.items()):
                agg = self._objective_entry(spec, "")
                if agg is None:
                    continue
                tenants = sorted(
                    ten for (obj, ten) in self._series if obj == name and ten
                )
                objectives[name] = {
                    "objective": spec.objective,
                    **agg,
                    "tenants": {
                        ten: self._objective_entry(spec, ten) for ten in tenants
                    },
                }
            deterministic = {
                "objectives": objectives,
                "breaches": list(self._breaches),
                "breaches_total": self._breach_count,
            }
        digest = hashlib.sha256(
            json.dumps(deterministic, sort_keys=True).encode()
        ).hexdigest()
        out = dict(deterministic)
        out["digest"] = digest
        return out


_ENGINE = SLOEngine()


def engine() -> SLOEngine:
    return _ENGINE


def configure(clock: Optional[Clock] = None, specs=None) -> SLOEngine:
    return _ENGINE.configure(clock=clock, specs=specs)
