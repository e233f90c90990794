"""Provisioning traffic: passes of `Scheduler.solve` over a pending set.

Closed loop, one client. Each pass brings its arrivals (new pod objects,
built before the pass's clock starts: that is the client's work), builds
a Topology and a Scheduler over every pending pod and solves them; the
pass ends when its decisions are on the host. Then the oldest pending pods
leave (bound), as many as the traffic says. A burst is a backlog of none,
a batch of arrivals and every pod leaving; churn is a standing backlog, a
few arrivals of one shape and as many departures.

Traffic parameters: `backlog`, `arrivals` ({"pods", "kind": "batch" |
"one_shape"}), `departures` (a count or "all"), `warmup_passes`,
`options` (fields of the program's Options to set), `compare`
({"one_in": n, "max": m}: the first measured pass and passes drawn from
the seed, at most m in all).

The garbage collector runs where the allocations trigger it. A pass's
time is its own wall time plus the collections that ran since the pass
before it ended (`GcClock`): those free the system's garbage of earlier
passes as much as the client's, and a controller would pay for them.
Set-up ends with a full collection and `gc.freeze()`, so the objects
set-up leaves alive are not scanned again, as in a controller long past
its start.
"""

from __future__ import annotations

import contextlib
import gc
import time

from benchmark.harness import traffic as gen
from benchmark.harness import workload as wl
from benchmark.harness.gcclock import GcClock
from benchmark.harness.judge import judge_provisioning


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, tracer):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.tracer = device, tracer
        self.units: list = []  # (seconds, pods decided, pods not placed: errors or undecided)
        self.kept: list = []  # (demands, decisions) of the compared passes
        self.pass_no = 0
        self.gc = GcClock(tracer)
        self.gc_mark = 0.0  # the collector's total when the last pass ended
        self.between_s = 0.0  # the window's client work between passes (pods built), less collections
        self.gc_outside_s = 0.0  # the window's collections between passes, counted in them

    # -- set-up ---------------------------------------------------------------

    def setup(self) -> None:
        from karpenter_tpu_torch.ops.catalog import CatalogEngine

        apply_options(self.traffic.get("options", {}))
        self.gc.start()
        catalog = wl.build_catalog(self.config["catalog"])
        self.engine = CatalogEngine(catalog, device=self.device)
        self.ctx = wl.SolveContext(self.config["nodepools"], catalog, self.engine)
        self.gen = gen.PodTraffic(self.config["pods"], self.traffic, self.seed)
        self.factory = wl.PodFactory(self.gen.shapes)
        self.pending_d = self.gen.backlog()
        self.pending = self.factory.pods(self.pending_d)
        for _ in range(self.traffic["warmup_passes"]):
            self._pass(measure=False)
        # set-up's garbage collected, and what it leaves alive (imports,
        # catalog, engine, the standing backlog) kept out of every later
        # collection's scan: a long-running controller's start-up state
        gc.collect()
        gc.freeze()
        self.gc_mark = self.gc.total

    # -- the window -------------------------------------------------------------

    def run(self, seconds: float) -> None:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self._pass(measure=True)

    def _pass(self, measure: bool) -> None:
        import torch

        k = self.pass_no
        self.pass_no += 1
        t_build = time.perf_counter()
        arrivals = self.gen.arrivals(k)
        self.pending_d.extend(arrivals)
        self.pending.extend(self.factory.pods(arrivals))
        pods = list(self.pending)
        outside = self.gc.total - self.gc_mark  # collections since the last pass ended
        tr = self.tracer  # its spans record only inside the traced window
        with tr.span("unit"), _batch_scope() if tr.active else contextlib.nullcontext() as acc:
            t0 = time.perf_counter()
            with tr.span("scheduler_build"):
                scheduler = self.ctx.scheduler(pods)
            with tr.span("solve"):
                results = scheduler.solve(pods)
                if self.engine.device.type == "cuda":
                    torch.cuda.synchronize()
            dt = time.perf_counter() - t0 + outside
        self.gc_mark = self.gc.total
        if acc is not None:
            tr.records["dispatches"].append(acc["dispatches"])
        if measure:
            self.between_s += t0 - t_build - outside
            self.gc_outside_s += outside
            decided = (sum(len(nc.pods) for nc in results.new_node_claims)
                       + sum(len(en.pods) for en in results.existing_nodes)
                       + len(results.pod_errors))
            self.units.append((dt, decided, len(pods) - decided + len(results.pod_errors)))
            if gen.compared(self.traffic, self.seed, k, len(self.kept)):
                self.kept.append((list(self.pending_d), wl.decisions(results, uid=gen.canonical_uid)))
        n = self.gen.departures(self.pending)
        del self.pending[:n]
        del self.pending_d[:n]

    # -- after the window -------------------------------------------------------

    def finish(self) -> None:
        """Free the program; the judge needs only the kept decisions."""
        self.gc.stop()
        self.pending = self.pending_d = None
        self.ctx = self.engine = None

    def judge(self) -> dict:
        return judge_provisioning(self.config, self.gen.shapes, self.kept)

    def attempted(self) -> tuple:
        return len(self.units), sum(1 for u in self.units if u[2])

    def notes(self) -> list:
        """Lines for standard error: where the window's time went outside
        the passes."""
        return [f"between passes: {self.between_s:.3f} s building arrivals and keeping decisions; "
                f"{self.gc_outside_s:.3f} s of collections there, counted in the next pass; "
                f"{self.gc.collections} collections, {self.gc.total:.3f} s in all since set-up began"]


def apply_options(opts: dict) -> None:
    """Set the program's options as its operator does (operator.py:106-120):
    the fused-solve mode and the delta-solve mode with its self-check
    cadence, each only where the traffic names it; Options() otherwise."""
    from karpenter_tpu_torch.operator.options import Options

    o = Options(**opts)
    if o.fused_solve:
        from karpenter_tpu_torch.ops import fused

        fused.FUSED_MODE = o.fused_solve
    if o.delta_solve:
        from karpenter_tpu_torch.ops import delta

        delta.configure(mode=o.delta_solve, resolve_full_every=o.resolve_full_every)


def _batch_scope():
    from karpenter_tpu_torch.observability.kernels import registry

    return registry().batch_scope("benchmark")
