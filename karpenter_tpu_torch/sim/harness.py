"""The simulator: a deterministic, trace-driven, virtual-time event loop
around the REAL operator — every controller, the solverd client, and the
kwok cloud provider, exactly as `python -m karpenter_tpu_torch` wires them.

Virtual time: a single FakeClock drives everything. The loop never sleeps;
it jumps the clock to the next due event (trace event, controller tick, or
a blocked worker thread's wakeup) and runs one cooperative operator pass
when a tick is due. A 400-virtual-second scenario runs in well under a
wall-clock second.

Determinism: the trace is a pure function of the seed, a seeded uid source
replaces uuid4 for object names, fault coin-flips and victim selection use
dedicated seeded streams, and the operator loop itself is single-threaded —
so identical seeds yield byte-identical event logs (compare digests).

The harness also plays the two cluster roles the framework leaves external:
a ReplicaSet stand-in (workload groups resubmit pods that were evicted or
lost, until the group's completion time) and a pod-GC stand-in (pods bound
to a Node that vanished out-of-band are deleted, then resubmitted by their
group).
"""

from __future__ import annotations

import math
import shutil
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field
from random import Random
from typing import Optional

from karpenter_tpu_torch.apis import core as apicore
from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import (
    Condition,
    Container,
    LabelSelector,
    ObjectMeta,
    Pod,
    PodSpec,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.kwok.provider import KwokCloudProvider
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.operator.operator import Operator
from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.runtime.journal import IDEMPOTENCY_ANNOTATION, OperatorCrash
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.sim import trace as tracemod
from karpenter_tpu_torch.sim.accounting import Accountant, node_facts
from karpenter_tpu_torch.sim.events import EventLog
from karpenter_tpu_torch.sim.faults import FaultyCloudProvider, FlakySolverClient, interrupt
from karpenter_tpu_torch.utils.clock import FakeClock
from karpenter_tpu_torch.utils.resources import parse_resource_list

GROUP_LABEL = "sim.kwok.sh/group"


@dataclass
class SimResult:
    report: dict
    digest: str
    log: EventLog


@dataclass
class _Group:
    name: str
    desired: int
    pod_spec: dict
    until: Optional[float]  # absolute virtual time; None = end of trace
    replace: bool
    serial: int = 0  # replacement counter (deterministic replica names)
    done: bool = False


def build_pod(name: str, group: str, spec: dict) -> Pod:
    """Trace pod template -> an unschedulable Pod (the shape the reference's
    test.UnschedulablePod builder produces, so it is provisionable)."""
    node_selector: dict[str, str] = {}
    if spec.get("capacity_type"):
        node_selector[wk.CAPACITY_TYPE_LABEL_KEY] = spec["capacity_type"]
    if spec.get("zone"):
        node_selector[wk.LABEL_TOPOLOGY_ZONE] = spec["zone"]
    if spec.get("arch"):
        node_selector[wk.LABEL_ARCH] = spec["arch"]
    labels = {GROUP_LABEL: group}
    labels.update(spec.get("labels", {}))
    requests = {
        "cpu": str(spec.get("cpu", "1")),
        "memory": str(spec.get("memory", "1Gi")),
    }
    pod = Pod(
        metadata=ObjectMeta(name=name, labels=labels),
        spec=PodSpec(
            node_selector=node_selector,
            containers=[Container(requests=parse_resource_list(requests))],
        ),
    )
    if spec.get("spread") == "zone":
        pod.spec.topology_spread_constraints = [
            TopologySpreadConstraint(
                max_skew=1,
                topology_key=wk.LABEL_TOPOLOGY_ZONE,
                when_unsatisfiable="DoNotSchedule",
                label_selector=LabelSelector(match_labels={GROUP_LABEL: group}),
            )
        ]
    pod.status.conditions.append(
        Condition(type="PodScheduled", status="False", reason="Unschedulable")
    )
    return pod


# Pinned device RTT for _use_device routing (ops/catalog.device_rtt_s):
# the measured RTT is wall-clock and machine-dependent, so borderline
# cubes could route host on one run and device on the next — and
# report["kernels"] dispatch counts would not be a pure function of
# (scenario, seed). port: 100 us is the reference's pin, kept so that both
# packages route every batch alike: small cubes keep the exact host twins,
# large cubes keep the device. It is a routing constant, not a measured
# figure (the card's round trip is in PERF.md, phase 4h).
PINNED_RTT_S = 100e-6


@contextmanager
def sim_globals(seed: int, clock: FakeClock):
    """The process-global discipline every deterministic run needs, held
    for exactly the run's duration: seeded uid source, blocking FakeClock
    sleeps, a fresh kernel-observatory warmup window, hermetic engines
    (a content-cached engine from an earlier sim would already be warm and
    its warmup dispatches would not repeat), and the pinned device RTT.
    One `with` block serves a single-tenant Simulation.run() or a whole
    multi-tenant FleetSimulation — the globals are process-wide either
    way, so they must be entered once per run, never per cell."""
    from karpenter_tpu_torch.controllers.provisioning import provisioner as provmod
    from karpenter_tpu_torch.observability import flight as flightmod
    from karpenter_tpu_torch.observability import kernels as kobs
    from karpenter_tpu_torch.observability import slo as slomod
    from karpenter_tpu_torch.ops import catalog as catmod

    from karpenter_tpu_torch.observability import efficiency as effmod

    apicore.set_uid_source(Random(f"{seed}:uids"))
    clock.enable_blocking_sleep()
    kobs.registry().unseal()
    # fresh SLO/flight state per run (specs, sources, and subscribers were
    # wired at operator construction and survive): burn-rate series,
    # breach history, frames, and bundle sequence all restart at zero so
    # report["slo"]/report["flight"] are pure functions of (scenario, seed)
    slomod.engine().reset()
    flightmod.recorder().reset()
    # fresh provenance ledger per run (mode/capacity survive — they were
    # configured at operator construction): ring, staging, and fused-decline
    # taxonomy restart at zero so report["explain"] and its digest are pure
    # functions of (scenario, seed)
    from karpenter_tpu_torch.observability import explain as explainmod

    explainmod.recorder().reset()
    # device-profiler sequence + cooldowns restart so breach-armed capture
    # names (recorded in flight bundle contexts) are a pure function of
    # the run, not of process history
    effmod.profiler().reset()
    provmod._ENGINE_CONTENT_CACHE.clear()
    pinned_prev = catmod.PINNED_RTT
    catmod.PINNED_RTT = PINNED_RTT_S
    try:
        yield
    finally:
        catmod.PINNED_RTT = pinned_prev
        apicore.set_uid_source(None)
        clock.disable_blocking_sleep()


class Simulation:
    def __init__(
        self,
        trace: dict,
        seed: int,
        options: Optional[Options] = None,
        registration_delay: float = 2.0,
        trace_export: Optional[str] = None,
        clock: Optional[FakeClock] = None,
        solver_factory=None,
        configure_tracer: bool = True,
        device=None,
    ):
        tracemod.validate(trace)
        self.trace = trace
        self.seed = seed
        # port: the device the run's engines are built on, through every
        # rebuild (solverd restart, crash restart): None is the card, "cpu"
        # the plain versions of the kernels
        self.device = device
        self.clock = clock if clock is not None else FakeClock()
        self.t0 = self.clock.now()
        self.log = EventLog()
        self.store = Store(clock=self.clock)
        self.kwok = KwokCloudProvider(
            self.store, self.clock, registration_delay=registration_delay
        )
        faults = trace.get("faults", {}) or {}
        self.provider = FaultyCloudProvider(
            self.kwok,
            rng=Random(f"{seed}:cloud-faults"),
            clock=self.clock,
            launch_failure_rate=faults.get("launch_failure_rate", 0.0),
            insufficient_capacity_rate=faults.get("insufficient_capacity_rate", 0.0),
            ack_then_raise_rate=faults.get("ack_then_raise_rate", 0.0),
            api_latency=faults.get("api_latency", 0.0),
            api_jitter=faults.get("api_jitter", 0.0),
            outages=[
                (self.t0 + float(o["at"]), self.t0 + float(o["at"]) + float(o["duration"]))
                for o in faults.get("outages", [])
            ],
            on_fault=self._on_fault,
        )
        self.options = options if options is not None else Options()
        # crash-injection scenarios need a REAL on-disk journal: the
        # cold-restarted operator recovers by re-reading the same files the
        # dead one fsync'd, so an in-memory journal would make the exercise
        # vacuous. A tempdir is provisioned only when the trace actually
        # crashes the operator and no --journal-dir was given; finalize()
        # removes it.
        self._journal_tmpdir = None
        if not self.options.journal_dir and any(
            e.get("kind") == "operator-crash" for e in trace.get("events", [])
        ):
            self._journal_tmpdir = tempfile.mkdtemp(prefix="ktpu-journal-")
            self.options.journal_dir = self._journal_tmpdir
        self.operator = Operator(
            self.store, self.provider, clock=self.clock, options=self.options,
            engine_factory=self._engine_factory(),
        )
        # a multi-tenant coordinator (sim/fleet.py) swaps the freshly built
        # in-process client for its shared replica pool BEFORE any fault
        # wrapping, so the flaky layer and the scenario see the pool
        self._solver_factory = solver_factory
        if solver_factory is not None:
            self.operator.provisioner.solver = solver_factory(self)
        # re-install the tracer the Operator just configured, in DETERMINISTIC
        # mode: full sampling (journeys and the span digest must be complete),
        # volatile wall-clock attrs dropped at export — so two same-seed runs
        # emit byte-identical span logs, and the digest below is a regression
        # fingerprint exactly like the event-log digest. (The tracer is
        # process-global: a multi-tenant coordinator configures it ONCE
        # after building every cell, so it passes configure_tracer=False.)
        from karpenter_tpu_torch import tracing

        if configure_tracer:
            self.tracer = tracing.configure(
                clock=self.clock,
                sample_rate=1.0,
                deterministic=True,
                buffer_size=self.options.trace_buffer_size,
                jsonl_path=trace_export,
            )
        else:
            self.tracer = tracing.tracer()
        self.operator.tracer = self.tracer
        # the operator's cloud-provider circuit breaker is part of the
        # scenario's observable record: every transition lands in the event
        # log (deterministic — virtual time, seeded faults), and the
        # Accountant folds them into report["breaker"]
        self.operator.breaker.subscribe(
            lambda old, new: self.log.append(
                self._rel(self.clock.now()), "breaker", **{"from": old, "to": new}
            )
        )
        # SLO breaches are part of the scenario's observable record: every
        # edge-triggered breach lands in the event log (deterministic —
        # burn rates over virtual time) exactly like breaker transitions.
        # Keyed replace: a multi-tenant coordinator overrides this with one
        # pool-level subscription after building its cells.
        from karpenter_tpu_torch.observability import slo as slomod

        slomod.engine().subscribe(self._on_slo_breach, key="sim")
        # kept for solverd-restart: the rebuilt client must re-wrap with the
        # SAME flaky profile and the SAME rng stream (mid-stream — byte
        # determinism depends on continuing it, not reseeding)
        self._solver_rejection_rate = faults.get("solver_rejection_rate", 0.0)
        self._solver_fault_rng = Random(f"{seed}:solver-faults")
        if self._solver_rejection_rate > 0:
            self.operator.provisioner.solver = FlakySolverClient(
                self.operator.provisioner.solver,
                rng=self._solver_fault_rng,
                rejection_rate=self._solver_rejection_rate,
                on_fault=self._on_fault,
            )
        # ffd's solve counters are module globals that accumulate across
        # every sim in the process; snapshot them so the report carries
        # THIS run's deltas and stays reproducible run-over-run
        from karpenter_tpu_torch.ops import ffd

        self._ffd_base = {
            "joint_sweeps": ffd.JOINT_SWEEPS,
            "device_solves": ffd.DEVICE_SOLVES,
            "device_fallbacks": ffd.DEVICE_FALLBACKS,
        }
        # incremental-delta residencies (ops/delta.py) are process-global
        # and keyed by engine identity; the solverd engine factory content-
        # caches engines, so a second in-process run would otherwise
        # warm-resume against state seeded by the PREVIOUS run. Drop them,
        # then snapshot the counters for this run's report delta.
        from karpenter_tpu_torch.ops import delta as deltamod

        deltamod.invalidate_all("sim-run-start")
        self._delta_base = dict(deltamod.delta_counters())
        # kernel observatory: same delta discipline — report["kernels"] is
        # built from a counts_snapshot taken at run start (run() also
        # unseals, so this run's prewarm/first-batch dispatches land in the
        # warmup phase exactly like a cold process's would)
        from karpenter_tpu_torch.observability import kernels as kobs

        self._kernels_base = kobs.registry().counts_snapshot()
        # consolidation frontier counters (methods.py): snapshot for
        # per-run deltas — rounds/probes/coalesced groups are scenario
        # facts and belong in the deterministic report surface
        self._frontier_base = self._frontier_snapshot()
        # AOT compile-service traffic (cache hits/misses, fresh compiles,
        # off-ladder dispatches): snapshotted so the report carries this
        # run's deltas; the section rides OUTSIDE the kernels digest — a
        # warm second run legitimately hits the cache a cold first run
        # missed, and that must not break report-digest equality
        from karpenter_tpu_torch.aot import runtime as aotrt

        self._aot_base = aotrt.stats()
        # efficiency observatory (host-stall attribution + cost tables):
        # steady-batch counters are process-cumulative, so the report
        # section is a delta from run start, like the kernels section
        from karpenter_tpu_torch.observability import efficiency as effmod

        self._eff_base = effmod.snapshot_base()
        self._victim_rng = Random(f"{seed}:victims")
        # crash-consistency ledger: counts accumulated across every injected
        # crash and every Operator.recover() replay, folded into
        # report["recovery"] for ALL runs (zeros on crash-free scenarios, so
        # same-seed digest equality is unconditional)
        self._recovery = {
            "crashes": 0,
            "replayed": 0,
            "adoptions": 0,
            "orphans": 0,
            "rolled_back": 0,
        }
        self.operator.on_recover = self._on_recover
        self._groups: dict[str, _Group] = {}
        self._known_nodes: set[str] = set()
        self._known_claims: set[str] = set()
        self._bound: set[str] = set()

    def _engine_factory(self):
        """port: the Operator's engine factory on the run's device, as
        `python -m karpenter_tpu_torch` builds it (None for the host
        backend, which builds no engine)."""
        from karpenter_tpu_torch.controllers.provisioning import (
            provisioner as provmod,
        )

        if self.options.solver_backend != "tpu":
            return None
        return provmod.default_engine_factory(
            shard_devices=self.options.solver_pod_shard_axis, device=self.device
        )

    # -- event-log taps ------------------------------------------------------

    def _on_fault(self, ev: str, **fields) -> None:
        self.log.append(self._rel(self.clock.now()), ev, **fields)

    def _on_recover(self, stats: dict) -> None:
        self._recovery["replayed"] += stats.get("replayed", 0)
        self._recovery["adoptions"] += stats.get("adoptions", 0)
        self._recovery["orphans"] += stats.get("orphans", 0)
        self._recovery["rolled_back"] += stats.get("rolled_back", 0)
        # an all-zero recovery (every boot runs one — empty journal) stays
        # out of the log so crash-free scenario digests are untouched
        if any(stats.values()):
            self.log.append(
                self._rel(self.clock.now()), "operator-recovered", **stats
            )

    def _on_slo_breach(self, breach) -> None:
        self.log.append(
            self._rel(breach.t),
            "slo-breach",
            objective=breach.objective,
            tenant=breach.tenant,
            window=breach.window,
            burn_rate=round(breach.burn_rate, 6),
            budget_remaining=round(breach.budget_remaining, 6),
        )

    def _rel(self, t: float) -> float:
        return t - self.t0

    # -- the loop ------------------------------------------------------------

    # kept as a class attr for callers that referenced it here
    PINNED_RTT_S = PINNED_RTT_S

    def prepare(self) -> None:
        """Stage the run: create nodepools, arm the trace-event queue and
        the first controller tick. Split out of run() so a multi-tenant
        coordinator can prepare every cell before driving one shared
        clock."""
        for np_spec in self.trace.get("nodepools", [{"name": "workers"}]):
            self.store.create(self._nodepool(np_spec))
        self._events = list(self.trace["events"])
        self._next_pass = self.t0
        self._tick = float(self.trace.get("tick", 1.0))

    def next_due(self) -> float:
        """The next virtual time this cell needs the clock to reach: its
        next trace event or its next controller tick."""
        t_event = self.t0 + self._events[0]["at"] if self._events else math.inf
        return min(self._next_pass, t_event)

    def step(self) -> None:
        """Apply every due trace event, then run one operator pass if the
        tick is due — at the clock's CURRENT time (the caller owns time)."""
        while self._events and self.t0 + self._events[0]["at"] <= self.clock.now():
            self._apply(self._events.pop(0))
        if self.clock.now() >= self._next_pass:
            try:
                summary = self.operator.run_once()
            except OperatorCrash as crash:
                # the injected kill: the pass dies mid-flight at a journal
                # barrier; a cold operator replaces it on the same store +
                # journal dir and recovers on its first leader pass
                self._crash_restart(crash)
                summary = {}
            self._workloads()
            self._observe(summary)
            self._next_pass = self.clock.now() + self._tick

    def run(self) -> SimResult:
        end = self.t0 + float(self.trace["duration"])
        with sim_globals(self.seed, self.clock):
            self.prepare()
            while True:
                t_worker = self.clock.next_wakeup()
                t_next = min(
                    self.next_due(),
                    math.inf if t_worker is None else t_worker,
                )
                if t_next > end:
                    break
                if t_next > self.clock.now():
                    # virtual time jumps straight to the next due event —
                    # this is the "no sleeping" core of the simulator
                    self.clock.set_time(t_next)
                self.step()
            report = self.finalize(end)
            self.tracer.close()  # flush the JSONL export, if any
            return SimResult(report=report, digest=self.log.digest(), log=self.log)

    def finalize(self, end: float, process_sections: bool = True) -> dict:
        """Fold the run into its report and shut the operator down. The
        process-global sections (tracing digest, kernel observatory, AOT,
        frontier counters) are singletons — a multi-tenant coordinator
        passes process_sections=False per cell and folds them ONCE at pool
        level instead."""
        from karpenter_tpu_torch.observability import kernels as kobs

        report = Accountant(self.kwok.instance_types, self.t0).report(
            self.log,
            end,
            scenario=self.trace.get("name", ""),
            seed=self.seed,
            solver_stats=self._solver_stats(),
        )
        # crash-consistency verdict — in EVERY report (zeros on crash-free
        # runs), inside the deterministic surface: counts from the injected
        # crashes and the recoveries they forced, plus the two invariants
        # the journal exists to hold. double_launches is kwok's per-key
        # materialization ledger (kept across deletes). orphans_leaked is
        # an end-of-run sweep: an acknowledged instance is leaked only if
        # NO claim owns it by provider id or by idempotency key — a claim
        # mid-retry (create acked, response lost on the final pass) still
        # owns its instance by key and will converge, so it doesn't count.
        claims = self.store.list("NodeClaim")
        store_pids = {c.status.provider_id for c in claims if c.status.provider_id}
        store_keys = {
            c.metadata.annotations.get(IDEMPOTENCY_ANNOTATION, "") for c in claims
        }
        report["recovery"] = {
            "crashes": self._recovery["crashes"],
            "replayed_intents": self._recovery["replayed"],
            "adoptions": self._recovery["adoptions"],
            "orphans_marked": self._recovery["orphans"],
            "rolled_back": self._recovery["rolled_back"],
            "double_launches": self.kwok.double_launches(),
            "orphans_leaked": sum(
                1
                for inst in self.kwok.list()
                if inst.status.provider_id not in store_pids
                and inst.metadata.annotations.get(IDEMPOTENCY_ANNOTATION, "")
                not in store_keys
            ),
        }
        self.operator.shutdown()
        if self._journal_tmpdir is not None:
            shutil.rmtree(self._journal_tmpdir, ignore_errors=True)
        if not process_sections:
            return report
        # fold the scheduling traces into the report: the span-log
        # digest (determinism fingerprint) and per-stage journey
        # p50/p99 over every pod that completed its journey
        report["tracing"] = {
            "span_digest": self.tracer.digest.digest(),
            "spans": self.tracer.digest.count,
            "journeys": self.tracer.journeys.stats(),
        }
        # the kernel observatory section: per-(kernel, shape bucket,
        # phase) dispatch count deltas + steady recompiles, digested —
        # byte-deterministic across same-seed runs under the pinned RTT;
        # walls and compile counts ride in its volatile appendix
        report["kernels"] = kobs.registry().report(self._kernels_base)
        # AOT compile-service deltas, deliberately OUTSIDE the digest
        # (cache hits are process/disk history, not scenario facts)
        from karpenter_tpu_torch.aot import runtime as aotrt

        report["kernels"]["aot"] = aotrt.stats_delta(self._aot_base)
        # efficiency observatory, also OUTSIDE the digest (cost models and
        # measured walls are machine facts). Its deterministic half —
        # steady batch counts, dispatch counts, and the exact-1.0 fraction
        # of fully host-paced runs — still reproduces per seed, so
        # full-report equality holds on scenarios that never
        # device-dispatch under the pinned RTT.
        from karpenter_tpu_torch.observability import efficiency as effmod

        report["kernels"]["efficiency"] = effmod.report_section(self._eff_base)
        # incremental-delta counters (warm/cold passes, rows reused vs
        # re-encoded, bytes re-encoded, self-check verdicts, invalidations
        # by reason): this run's deltas, OUTSIDE the digest like aot —
        # residency is process history (the engine factory content-caches
        # engines across runs), not a scenario fact. All zeros with
        # --delta-solve off, so existing digests are untouched.
        from karpenter_tpu_torch.ops import delta as deltamod

        cur = deltamod.delta_counters()
        report["kernels"]["delta"] = {
            key: cur.get(key, 0) - self._delta_base.get(key, 0) for key in cur
        }
        # consolidation frontier search: this run's rounds/probes per
        # consolidation type plus the solverd frontier groups that
        # coalesced — deterministic (decision-path) facts
        snap = self._frontier_snapshot()
        report["frontier"] = {
            key: round(snap[key] - self._frontier_base[key], 6)
            for key in snap
        }
        # the SLO engine's verdict over the run — per-objective burn/budget
        # state, the breach stream, and its own digest — folded into the
        # accounting slo section; plus the flight recorder's ring/bundle
        # digests. Both are pure functions of (scenario, seed).
        from karpenter_tpu_torch.observability import flight as flightmod
        from karpenter_tpu_torch.observability import slo as slomod

        engine_report = slomod.engine().report()
        report["slo"]["objectives"] = engine_report["objectives"]
        report["slo"]["breaches"] = engine_report["breaches"]
        report["slo"]["breaches_total"] = engine_report["breaches_total"]
        report["slo"]["digest"] = engine_report["digest"]
        report["flight"] = flightmod.recorder().report()
        # the provenance ledger's verdict — per-stage elimination totals,
        # fused-decline taxonomy, and a sha256 digest over the canonical
        # ledger entries. Inside the deterministic surface: funnels carry
        # stages + error strings only (host/device parity-guaranteed), and
        # entry timestamps are virtual time.
        from karpenter_tpu_torch.observability import explain as explainmod

        report["explain"] = explainmod.recorder().report()
        return report

    @staticmethod
    def _frontier_snapshot() -> dict:
        from karpenter_tpu_torch.controllers.disruption import methods as dmethods
        from karpenter_tpu_torch.solverd import coalescer as dcoal

        out = {}
        for ctype in ("multi", "single"):
            labels = {"consolidation_type": ctype}
            out[f"{ctype}_rounds"] = float(
                dmethods._FRONTIER_ROUNDS.count(labels)
            )
            out[f"{ctype}_probes"] = dmethods._FRONTIER_PROBES.value(labels)
        out["coalesced_groups"] = dcoal._FRONTIER_GROUPS.value()
        return out

    def _solver_stats(self) -> dict:
        stats = dict(self.operator.solver_stats())
        for key, base in self._ffd_base.items():
            if isinstance(stats.get(key), int):
                stats[key] -= base
        # wall-clock measurements stay on /debug/solverd but OUT of the
        # report: the report must be a pure function of (scenario, seed)
        stats.pop("last_batch_seconds", None)
        stats.pop("last_batch_host_stall", None)
        return stats

    # -- trace events --------------------------------------------------------

    def _nodepool(self, spec: dict) -> NodePool:
        from karpenter_tpu_torch.apis.nodepool import Budget

        np_ = NodePool(metadata=ObjectMeta(name=spec["name"]))
        np_.spec.template.spec.requirements = list(spec.get("requirements", []))
        np_.spec.disruption.consolidate_after = spec.get("consolidate_after", 15.0)
        if spec.get("budgets"):
            # e.g. [{"nodes": "100%"}] — the default 10% budget caps
            # disruption at ONE node on small simulated fleets, which
            # forces every consolidation through the single-node path
            np_.spec.disruption.budgets = [Budget(**b) for b in spec["budgets"]]
        if spec.get("limits"):
            np_.spec.limits = parse_resource_list(spec["limits"])
        np_.set_condition("Ready", "True")
        self.log.append(self._rel(self.clock.now()), "nodepool", name=spec["name"])
        return np_

    def _apply(self, ev: dict) -> None:
        kind = ev["kind"]
        if kind == "submit":
            until = ev.get("until")
            group = _Group(
                name=ev["group"],
                desired=int(ev["count"]),
                pod_spec=dict(ev.get("pod", {})),
                until=None if until is None else self.t0 + float(until),
                replace=bool(ev.get("replace", False)),
            )
            self._groups[group.name] = group
            for i in range(group.desired):
                self._submit(group, f"{group.name}-{i}")
        elif kind == "interrupt":
            interrupt(
                self.store,
                self.provider,
                self._victim_rng,
                count=int(ev.get("count", 1)),
                mode=ev.get("mode", "graceful"),
                capacity_type=ev.get("capacity_type"),
                on_fault=self._on_fault,
            )
        elif kind == "solverd-restart":
            self._restart_solverd()
        elif kind == "operator-crash":
            # arm a one-shot kill at a named journal barrier; it fires on
            # the next matching intent/done, possibly several passes later
            self.operator.journal.arm_crash(
                ev.get("barrier", "post-intent-pre-effect"),
                action=ev.get("action"),
            )
        else:
            raise ValueError(f"unknown trace event kind {kind!r}")

    def _restart_solverd(self) -> None:
        """Restart the solver service mid-trace (the rolling-upgrade path
        ROADMAP item 2 hardens): the old client closes, engines and their
        device state are dropped (a restarted daemon holds none), and the
        next provisioning pass re-prewarms from scratch — against the
        persistent AOT executable cache when one is configured, which is
        exactly what the warm-start contract asserts stays fast."""
        from karpenter_tpu_torch.controllers.provisioning import (
            provisioner as provmod,
        )
        from karpenter_tpu_torch.observability import kernels as kobs
        from karpenter_tpu_torch.solverd import build_solver

        prov = self.operator.provisioner
        try:
            prov.solver.close()
        except KernelError:
            # port: a device fault is never a dying daemon's noise
            raise
        except Exception:  # noqa: BLE001 — a dying daemon can't block the sim
            pass
        prov.solver = build_solver(self.operator.options, self.clock)
        # the scenario's fault profile survives the restart: re-wrap the
        # fresh client, continuing the established rng stream
        if self._solver_rejection_rate > 0:
            prov.solver = FlakySolverClient(
                prov.solver,
                rng=self._solver_fault_rng,
                rejection_rate=self._solver_rejection_rate,
                on_fault=self._on_fault,
            )
        # cold-engine discipline: the restarted daemon rebuilds engines from
        # shipped catalogs, so both engine cache levels drop
        provmod._ENGINE_CONTENT_CACHE.clear()
        # ... and holds no executables: the AOT table empties so the
        # re-prewarm actually drives the persistent-cache LOAD path (not the
        # already-loaded fast path), and — when the compile service is on —
        # the jit caches drop too, so a cacheless restart honestly repays
        # its compiles. Deterministic: warm_start records one dispatch per
        # bucket whichever of compile/load/already served it.
        from karpenter_tpu_torch.aot import runtime as aotrt

        aotrt.clear_executables()
        # port: no jit caches to drop — the port's kernels are built
        # libraries, loaded once a process; a restarted daemon rebuilds its
        # engines (below), not its kernels
        if prov.engine_factory is not None:
            prov.engine_factory = provmod.default_engine_factory(
                shard_devices=prov.options.solver_pod_shard_axis,
                device=self.device,
            )
        # a restart reopens the warmup window: the re-prewarm (and the first
        # post-restart solve's residual compiles) are cold-start facts, not
        # steady-state recompiles
        prov._kernels_sealed = False
        prov._prewarm_traced = False
        kobs.registry().unseal()
        self.log.append(self._rel(self.clock.now()), "solverd-restart")

    def _crash_restart(self, crash: OperatorCrash) -> None:
        """Cold-restart the operator after an injected crash. The dying
        process gets NO orderly shutdown — only what the OS does for it
        (file handles drop; every journal frame was already fsync'd at
        append). The replacement is a fresh Operator on the same durable
        substrate: it stands by until the dead incumbent's lease goes stale
        (~15s virtual time), takes over, and runs Operator.recover()
        against the re-read journal before its first resync — adoption by
        idempotency key, orphan marking + GC expedite, and disruption
        rollback all happen there. In-process solver state dies with the
        operator (same cold-engine discipline as _restart_solverd), so the
        warm-restart contract — zero steady recompiles when the AOT cache
        is configured — is honestly exercised by the re-prewarm."""
        from karpenter_tpu_torch.aot import runtime as aotrt
        from karpenter_tpu_torch.controllers.provisioning import (
            provisioner as provmod,
        )
        from karpenter_tpu_torch.observability import kernels as kobs

        self._recovery["crashes"] += 1
        self.log.append(
            self._rel(self.clock.now()),
            "operator-crash",
            barrier=crash.barrier,
            action=crash.action or "",
        )
        old = self.operator
        old.journal.close()
        try:
            old.provisioner.solver.close()
        except KernelError:
            # port: a device fault is never a dying process's noise
            raise
        except Exception:  # noqa: BLE001 — a dying process can't block the sim
            pass
        # flight/SLO sources re-register under the same keys (keyed
        # replace), so the dead operator's callbacks fall away with it
        self.operator = Operator(
            self.store, self.provider, clock=self.clock, options=self.options,
            engine_factory=self._engine_factory(),
        )
        if self._solver_factory is not None:
            self.operator.provisioner.solver = self._solver_factory(self)
        self.operator.tracer = self.tracer
        self.operator.on_recover = self._on_recover
        # the new process's breaker transitions belong in the same
        # observable record as the old one's
        self.operator.breaker.subscribe(
            lambda old_state, new_state: self.log.append(
                self._rel(self.clock.now()),
                "breaker",
                **{"from": old_state, "to": new_state},
            )
        )
        # the scenario's fault profile survives the restart: re-wrap the
        # fresh client, continuing the established rng stream (byte
        # determinism depends on continuing it, not reseeding)
        if self._solver_rejection_rate > 0:
            self.operator.provisioner.solver = FlakySolverClient(
                self.operator.provisioner.solver,
                rng=self._solver_fault_rng,
                rejection_rate=self._solver_rejection_rate,
                on_fault=self._on_fault,
            )
        # cold-engine discipline, exactly as _restart_solverd: the crashed
        # process's engines and executables are gone; a configured AOT
        # cache is what makes the re-prewarm fast instead of a recompile
        provmod._ENGINE_CONTENT_CACHE.clear()
        aotrt.clear_executables()
        # port: no jit caches to drop (the kernels are built libraries)
        kobs.registry().unseal()

    def _submit(self, group: _Group, name: str) -> None:
        pod = build_pod(name, group.name, group.pod_spec)
        self.store.create(pod)
        self.log.append(
            self._rel(self.clock.now()), "pod-submitted", pod=name, group=group.name
        )

    # -- workload driver (ReplicaSet + pod-GC stand-ins) ---------------------

    def _workloads(self) -> None:
        now = self.clock.now()
        node_names = {n.metadata.name for n in self.store.list("Node")}
        for group in self._groups.values():
            if group.done:
                continue
            live = self.store.list(
                "Pod",
                predicate=lambda p: p.metadata.labels.get(GROUP_LABEL) == group.name,
            )
            if group.until is not None and now >= group.until:
                for p in live:
                    self.store.delete(p)
                group.done = True
                self.log.append(
                    self._rel(now), "group-complete", group=group.name, pods=len(live)
                )
                continue
            # pod-GC: a pod bound to a node that vanished out-of-band is lost
            survivors = []
            for p in live:
                if p.spec.node_name and p.spec.node_name not in node_names:
                    self.store.delete(p)
                    self.log.append(
                        self._rel(now), "pod-lost", pod=p.metadata.name,
                        node=p.spec.node_name,
                    )
                else:
                    survivors.append(p)
            # ReplicaSet stand-in: top the group back up to desired
            if group.replace:
                for _ in range(group.desired - len(survivors)):
                    group.serial += 1
                    self._submit(group, f"{group.name}-r{group.serial}")

    # -- state observation ---------------------------------------------------

    def _observe(self, summary: dict) -> None:
        t = self._rel(self.clock.now())
        nodes = {n.metadata.name: n for n in self.store.list("Node")}
        for name in sorted(nodes.keys() - self._known_nodes):
            facts = node_facts(nodes[name])
            self.log.append(t, "node-added", node=name, **facts)
        for name in sorted(self._known_nodes - nodes.keys()):
            self.log.append(t, "node-deleted", node=name)
        self._known_nodes = set(nodes)
        claims = {c.metadata.name for c in self.store.list("NodeClaim")}
        for name in sorted(claims - self._known_claims):
            self.log.append(t, "nodeclaim-added", nodeclaim=name)
        for name in sorted(self._known_claims - claims):
            self.log.append(t, "nodeclaim-deleted", nodeclaim=name)
        self._known_claims = claims
        bound_now = set()
        for p in self.store.list("Pod", predicate=lambda p: p.spec.node_name != ""):
            bound_now.add(p.metadata.name)
            if p.metadata.name not in self._bound:
                self.log.append(
                    t, "pod-bound", pod=p.metadata.name, node=p.spec.node_name
                )
        self._bound = bound_now
        if any(summary.values()):
            self.log.append(t, "pass", **summary)


def run_scenario(
    trace: dict,
    seed: int,
    options: Optional[Options] = None,
    trace_export: Optional[str] = None,
    device=None,
) -> SimResult:
    # port: `device`, the run's engines' device (None: the card)
    return Simulation(
        trace, seed, options=options, trace_export=trace_export, device=device
    ).run()



# port: the report sections that differ from the reference's by design,
# each with its reason. Every other part of a report is byte-identical to
# the reference's on the same (trace, seed), and so is the event log. A
# path is a tuple of keys, "*" any key or list index; in a fleet report it
# applies to the report and to each tenant's. Under the pinned RTT both
# packages route every row batch and sweep alike (ops/catalog.py), so the
# host records, the last batch's dispatches and the delta counters agree;
# what differs is how a dispatch to the device is bucketed and, for a row
# batch, counted (none of the registered scenarios sends one to the device
# under the pin; an AOT warm start walks the row rungs), and with it the
# flight frames that count dispatches. A run that dispatches nothing to
# the device, as most scenarios under the pin, gives the reference's whole
# report.
_ROW_RUNG = ("a row batch on the device is one kt_row_compat launch against the "
             "types and the offerings, two dispatches in the reference (one a "
             "target set); an AOT warm start walks the row rungs so, one "
             "executable a rung where the reference loads two")
DEVICE_SPECIFIC = (
    (
        ("kernels", "kernels", "*", "shapes"),
        "a device dispatch is bucketed by the port's operands: the sweep's "
        "entity rows and the catalog's own arrays, not the resident row "
        "matrices kt_cube reads by index (ops/catalog.py `_cube`); the row "
        "batch's one row table; the mesh's per-shard copies; host records "
        "share the reference's buckets",
    ),
    (("kernels", "kernels", "catalog.row_compat", "dispatches"), _ROW_RUNG),
    (("kernels", "kernels", "catalog.row_compat", "phases"), _ROW_RUNG),
    (("kernels", "digest"), "over those buckets and counts"),
    (("kernels", "aot", "executables_loaded"), _ROW_RUNG),
    (("kernels", "aot", "fresh_compiles"), _ROW_RUNG),
    (("kernels", "aot", "cache_hits"), _ROW_RUNG),
    (("kernels", "aot", "cache_misses"), _ROW_RUNG),
    (("kernels", "efficiency", "cost_tables", "entries"), _ROW_RUNG),
    (("flight", "ring_digest"), "its frames count the dispatches above"),
    (("flight", "bundles", "*", "sha256"), "a bundle's digest is over those frames"),
    (
        ("explain", "fused_declines"),
        "the scan's declines: the card's engine tries the scan on a batch of "
        "64 pods or more (auto), a CPU engine runs the walk and tries none",
    ),
)

# port: the part of a report that is measured, not counted. Wherever a
# batch dispatches to the device the host-stall fraction is a ratio of
# walls (a CPU engine dispatches the kernels' plain versions), in the
# reference too; a run whose batches all take the host twins reports
# exactly 1.0. Two same-seed runs give equal reports outside it.
VOLATILE = (
    (
        ("kernels", "efficiency", "host_stall_fraction"),
        "device-busy over batch wall, both measured",
    ),
)


def report_without(report: dict, entries=DEVICE_SPECIFIC) -> dict:
    """port: a copy of `report` without the parts `entries` names
    (DEVICE_SPECIFIC: what must then equal the reference's report, and a
    CPU engine's run on the card; VOLATILE: a same-seed rerun's)."""
    import copy

    out = copy.deepcopy(report)

    def drop(node, path):
        key, rest = path[0], path[1:]
        if isinstance(node, dict):
            keys = list(node) if key == "*" else [key] if key in node else []
        elif isinstance(node, list) and key == "*":
            keys = range(len(node))
        else:
            return
        for k in reversed(list(keys)):
            if rest:
                drop(node[k], rest)
            else:
                del node[k]

    for path, _reason in entries:
        drop(out, path)
        for tenant in out.get("tenants", {}).values():
            drop(tenant, path)
    return out
