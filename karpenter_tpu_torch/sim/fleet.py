"""Multi-tenant fleet simulation: N tenant clusters (each a full, real
operator cell — store, kwok cloud, every controller) sharing one solverd
replica pool on one virtual clock.

This is the deterministic harness for the solverd fleet's availability
story: every tenant's FleetClient routes by (tenant, catalog) affinity over
the shared pool, a `kill` event makes a replica vanish the way SIGKILL does
(connections refused, no drain, no goodbye — modeled at the transport
boundary, which is all a client can ever observe of a killed process), and
the run must recover deterministically: breakers open, routing converges on
the survivors, every replayed request id dedups, and no tenant's pods are
left unbound.

The report is a pure function of (trace, seed): per-tenant cost/SLO/churn
reports, a fleet section (per-replica execution audits, per-tenant failover
counters, the zero-double-execute verdict), the process-global tracing and
kernel-observatory sections folded once at pool level, and a combined
event-log digest over the time-merged tenant + fleet streams.
"""

from __future__ import annotations

import math
from dataclasses import replace as dc_replace
from typing import Optional

from karpenter_tpu_torch.operator.options import Options
from karpenter_tpu_torch.sim import trace as tracemod
from karpenter_tpu_torch.sim.events import EventLog
from karpenter_tpu_torch.sim.harness import SimResult, Simulation, sim_globals
from karpenter_tpu_torch.solverd import (
    FleetClient,
    InProcessClient,
    SolverService,
    TransportError,
)
from karpenter_tpu_torch.utils.clock import FakeClock


class KillableReplica(InProcessClient):
    """An in-process pool replica that can be killed mid-run. A killed
    replica answers every call the way a SIGKILLed daemon answers a socket
    client: connection refused, i.e. a typed retryable TransportError —
    the FleetClient's breaker and failover path see exactly what they
    would see in production."""

    def __init__(self, replica_id: str, service: SolverService):
        super().__init__(service)
        self.replica_id = replica_id
        self.dead = False

    def kill(self) -> None:
        self.dead = True
        # the process is gone: whatever the service held dies with it
        self.service.close()

    def _check(self) -> None:
        if self.dead:
            raise TransportError(
                f"connect {self.replica_id}: connection refused (killed)"
            )

    def encode(self, *args, **kwargs):
        # encode is host-side (client memory): it survives the kill; the
        # connection attempt in solve_prepared is what fails
        return super().encode(*args, **kwargs)

    def solve_prepared(self, prepared):
        self._check()
        return super().solve_prepared(prepared)

    def solve_many(self, *args, **kwargs):
        self._check()
        return super().solve_many(*args, **kwargs)

    def stats(self) -> dict:
        if self.dead:
            return {"transport": "inprocess", "error": "killed"}
        return super().stats()


class FleetSimulation:
    """Drive every tenant cell and the shared replica pool on one clock."""

    def __init__(
        self,
        trace: dict,
        seed: int,
        options: Optional[Options] = None,
        trace_export: Optional[str] = None,
        device=None,
    ):
        # port: `device`, every cell's engines' device (None: the card). The
        # replicas' services own no engine: a request's scheduler carries
        # its cell's engine, so the pool solves on the cells' device
        tracemod.validate(trace)
        if "fleet" not in trace:
            raise ValueError("FleetSimulation needs a trace with a 'fleet' section")
        self.trace = trace
        self.seed = seed
        self.clock = FakeClock()
        self.t0 = self.clock.now()
        self.fleet_log = EventLog()
        fleet = trace["fleet"]
        base = options or Options()

        tenant_weights = {
            t["name"]: float(t.get("weight", 1.0)) for t in trace["tenants"]
        }
        quota = int(fleet.get("tenant_quota", 0))
        self.services: list[SolverService] = []
        self.replicas: list[KillableReplica] = []
        for i in range(int(fleet["replicas"])):
            service = SolverService(
                clock=self.clock,
                max_queue_depth=base.solverd_queue_depth,
                tenant_quota=quota,
                tenant_weights=tenant_weights,
            )
            self.services.append(service)
            self.replicas.append(KillableReplica(f"replica-{i}", service))

        self.cells: list[Simulation] = []
        self.names: list[str] = []
        self.clients: dict[str, FleetClient] = {}
        for idx, spec in enumerate(trace["tenants"]):
            name = spec["name"]

            def solver_factory(cell, name=name):
                client = FleetClient(
                    [(r.replica_id, r) for r in self.replicas],
                    clock=self.clock,
                    tenant=name,
                    breaker_threshold=base.solverd_replica_breaker_threshold,
                    breaker_cooldown=base.solverd_replica_breaker_cooldown,
                )
                self.clients[name] = client
                return client

            cell = Simulation(
                spec["trace"],
                # distinct per-tenant seeds: three identical workloads would
                # otherwise draw identical fault/victim streams
                seed + idx,
                options=dc_replace(base, cluster_name=name),
                clock=self.clock,
                solver_factory=solver_factory,
                configure_tracer=False,
                device=device,
            )
            self.cells.append(cell)
            self.names.append(name)

        # the process-global tracer, configured ONCE after every cell's
        # Operator construction (each construction re-configures it):
        # deterministic mode so the combined span digest is a fingerprint
        from karpenter_tpu_torch import tracing

        self.tracer = tracing.configure(
            clock=self.clock,
            sample_rate=1.0,
            deterministic=True,
            buffer_size=base.trace_buffer_size,
            jsonl_path=trace_export,
        )
        for cell in self.cells:
            cell.tracer = self.tracer
            cell.operator.tracer = self.tracer
        # pool-level SLO breach subscription: the cells each registered the
        # single-tenant "sim" subscriber at construction — keyed replace
        # swaps in ONE pool-level tap so every breach (tenant-tagged or
        # aggregate) lands exactly once, in the fleet stream
        from karpenter_tpu_torch.observability import slo as slomod

        slomod.engine().subscribe(self._on_slo_breach, key="sim")
        self._kills = sorted(
            fleet.get("kills", []), key=lambda k: (k["at"], k["replica"])
        )
        self.killed: list[str] = []

    # -- the loop ------------------------------------------------------------

    def _rel(self, t: float) -> float:
        return t - self.t0

    def _on_slo_breach(self, breach) -> None:
        self.fleet_log.append(
            self._rel(breach.t),
            "slo-breach",
            objective=breach.objective,
            tenant=breach.tenant,
            window=breach.window,
            burn_rate=round(breach.burn_rate, 6),
            budget_remaining=round(breach.budget_remaining, 6),
        )

    def _apply_kills(self) -> None:
        while self._kills and self.t0 + self._kills[0]["at"] <= self.clock.now():
            kill = self._kills.pop(0)
            replica = self.replicas[int(kill["replica"])]
            replica.kill()
            self.killed.append(replica.replica_id)
            self.fleet_log.append(
                self._rel(self.clock.now()), "replica-kill",
                replica=replica.replica_id,
            )

    def run(self) -> SimResult:
        end = self.t0 + float(self.trace["duration"])
        with sim_globals(self.seed, self.clock):
            for cell in self.cells:
                cell.prepare()
            while True:
                t_kill = (
                    self.t0 + self._kills[0]["at"] if self._kills else math.inf
                )
                t_worker = self.clock.next_wakeup()
                t_next = min(
                    min(cell.next_due() for cell in self.cells),
                    t_kill,
                    math.inf if t_worker is None else t_worker,
                )
                if t_next > end:
                    break
                if t_next > self.clock.now():
                    self.clock.set_time(t_next)
                self._apply_kills()
                # fixed tenant order per step: the interleaving is part of
                # the determinism contract
                for cell in self.cells:
                    cell.step()
            report = self._finalize(end)
            self.tracer.close()
            merged = self._merged_log()
            report["event_log_digest"] = merged.digest()
            return SimResult(report=report, digest=merged.digest(), log=merged)

    # -- reporting -----------------------------------------------------------

    def _merged_log(self) -> EventLog:
        """One time-merged log over every tenant stream plus the fleet
        events, each entry stamped with its origin — the combined digest is
        the run's fingerprint. Ties break by stream order (fleet first,
        then tenants in trace order) and intra-stream position — both
        deterministic."""
        streams = [("fleet", self.fleet_log)] + [
            (name, cell.log) for name, cell in zip(self.names, self.cells)
        ]
        tagged = []
        for order, (origin, log) in enumerate(streams):
            for position, entry in enumerate(log):
                tagged.append((entry["t"], order, position, origin, entry))
        tagged.sort(key=lambda item: item[:3])
        merged = EventLog()
        for t, _order, _position, origin, entry in tagged:
            fields = {
                k: v for k, v in entry.items() if k not in ("t", "ev")
            }
            if origin != "fleet":
                fields["tenant"] = origin
            merged.append(t, entry["ev"], **fields)
        return merged

    def _double_executed(self) -> dict:
        """The zero-double-execute audit: a request id executed twice on one
        replica means the dedup failed; one executed on two replicas means
        a replay re-ran a solve that had already run (possible only when a
        reply is lost AFTER execution — the at-least-once edge the clean
        SIGKILL never produces). Both must be zero here."""
        same_replica = 0
        seen: dict[str, int] = {}
        cross_replica = 0
        overflow = False
        for service in self.services:
            overflow = overflow or service.executed_ids_overflow
            for rid, count in service.executed_ids.items():
                if count > 1:
                    same_replica += count - 1
                if rid in seen:
                    cross_replica += 1
                seen[rid] = seen.get(rid, 0) + 1
        return {
            "same_replica": same_replica,
            "cross_replica": cross_replica,
            "total": same_replica + cross_replica,
            "audit_overflow": overflow,
        }

    def _finalize(self, end: float) -> dict:
        from karpenter_tpu_torch.observability import flight as flightmod
        from karpenter_tpu_torch.observability import kernels as kobs
        from karpenter_tpu_torch.observability import slo as slomod

        engine = slomod.engine()
        tenants = {}
        for name, cell in zip(self.names, self.cells):
            tenants[name] = cell.finalize(end, process_sections=False)
            # the per-tenant SLO section: this tenant's burn/budget state
            # for every objective its tag appeared on — the shape the
            # ~100-cell macrobench scales to
            tenants[name]["slo"]["objectives"] = engine.tenant_section(name)
        replicas = []
        for service, replica in zip(self.services, self.replicas):
            replicas.append(
                {
                    "id": replica.replica_id,
                    "killed": replica.dead,
                    "requests": service.requests,
                    "executed": service.executed,
                    "batches": service.batches,
                    "rejected": service.rejected,
                    "deduped": service.deduped,
                    "unique_request_ids": len(service.executed_ids),
                }
            )
        clients = {}
        for name in self.names:
            client = self.clients.get(name)
            if client is None:
                continue
            stats = client.stats()
            clients[name] = {
                "failovers": stats["failovers"],
                "replays": stats["replays"],
                "draining_failovers": stats["draining_failovers"],
                "healthy_replicas": stats["healthy_replicas"],
                "solves_by_replica": {
                    r["id"]: r["solves"] for r in stats["replicas"]
                },
                "breakers": {
                    r["id"]: r["breaker"] for r in stats["replicas"]
                },
            }
        report = {
            "report_version": 1,
            "scenario": self.trace.get("name", ""),
            "seed": self.seed,
            "virtual_duration_s": round(end - self.t0, 6),
            "tenants": tenants,
            "fleet": {
                "replicas": replicas,
                "replica_kills": list(self.killed),
                "clients": clients,
                "double_executed": self._double_executed(),
            },
            # process-global sections folded ONCE at pool level: the span
            # digest covers every tenant's spans, the kernel section the
            # pool's dispatch counts (the surviving replica's steady
            # recompiles must stay 0 through the kill)
            "tracing": {
                "span_digest": self.tracer.digest.digest(),
                "spans": self.tracer.digest.count,
            },
            "kernels": kobs.registry().report(
                self.cells[0]._kernels_base if self.cells else None
            ),
            # pool-level SLO verdict (per-tenant attribution inside) and
            # the flight recorder's ring/bundle digests — one engine, one
            # blackbox, folded once like the tracing section
            "slo": engine.report(),
            "flight": flightmod.recorder().report(),
        }
        # the efficiency observatory folds once at pool level too (its
        # steady-batch counters are process-global, like the kernel
        # counts); outside the kernels digest, deterministic for
        # host-only scenarios exactly like the single-cell report
        from karpenter_tpu_torch.observability import efficiency as effmod

        report["kernels"]["efficiency"] = effmod.report_section(
            self.cells[0]._eff_base if self.cells else None
        )
        return report


def run_fleet_scenario(
    trace: dict,
    seed: int,
    options: Optional[Options] = None,
    trace_export: Optional[str] = None,
    device=None,
) -> SimResult:
    # port: `device`, the cells' engines' device (None: the card)
    return FleetSimulation(
        trace, seed, options=options, trace_export=trace_export, device=device
    ).run()
