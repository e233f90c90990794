"""Request coalescer: execute a batch of solve requests as shape-bucketed
device batches.

Concurrent requests are bucketed by the CatalogEngine they target (requests
against different catalogs can't share a sweep). For each bucket with 2+
device-eligible requests, the coalescer unions the joint (template x group)
requirement row-sets every request would sweep (ffd.collect_joint_rowsets)
and primes the engine's joint-mask cache with ONE batched feasibility
dispatch (ffd.prime_joint_masks). The per-request solves that follow find
their masks warm — a provisioning solve and N consolidation simulations
that used to cost N+1 device sweeps ride one.

Solves still run sequentially within the batch: the FFD simulation is
host-sequential by design (each placement mutates claim state) and the
device work IS the sweep being coalesced. Singleton batches skip the
priming pass entirely — collect-then-solve would group the pods twice for
zero sharing.

Tracing: each request's solve runs under a `solverd.solve` span parented
to the ORIGINATING trace via the request's carried context (never the
ambient context — a coalesced batch executes many callers' requests on one
leader thread). The span attributes the solve's wall time to kernel
compile vs execute (tracing/kernel.py, block_until_ready-fenced) and its
cache behavior to joint-mask / native-pack hits and misses — both recorded
as volatile attrs since they are process-history, not scenario, facts.
"""

from __future__ import annotations

import time

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.metrics import global_registry, measure
from karpenter_tpu_torch.observability import explain as explmod
from karpenter_tpu_torch.observability import kernels as kobs
from karpenter_tpu_torch.tracing import kernel as ktime

_SOLVE_LATENCY = global_registry.histogram(
    "karpenter_solverd_solve_latency_seconds",
    "per-request solve execution time inside a batch",
    labels=["kind"],
)
_COALESCED = global_registry.counter(
    "karpenter_solverd_coalesced_requests_total",
    "requests that shared a primed device batch with at least one other",
)
_PRIMED = global_registry.counter(
    "karpenter_solverd_primed_rowsets_total",
    "joint requirement row-sets primed by coalesced sweeps",
)
_FRONTIER_GROUPS = global_registry.counter(
    "karpenter_solverd_frontier_groups_total",
    "frontier-tagged request groups whose joint masks were primed from "
    "their largest member",
)


class Coalescer:
    def execute(self, entries: list) -> None:
        """Run every entry's solve, filling entry.result / entry.error.
        Entries are anything with `.request` (a SolveRequest) plus writable
        `result`/`error` slots; completion signalling is the caller's job."""
        from karpenter_tpu_torch.ops import ffd

        self._prime(entries)
        tracer = tracing.tracer()
        # one device-memory sample per BATCH, taken lazily at the first
        # sampled solve and shared by every span in it: the live-array set
        # moves per batch (requests share the engine), and jax.live_arrays
        # is an O(live arrays) enumeration that must not run per request
        mem_live: list = []
        for entry in entries:
            req = entry.request
            ctx = tracer.context_from(getattr(req, "trace_context", None))
            with tracer.span(
                "solverd.solve", parent=ctx, kind=req.kind, pods=len(req.pods)
            ) as span:
                if not span.sampled:
                    # no span to attribute to: skip the kernel timer so the
                    # solve's device dispatches are NOT block_until_ready
                    # fenced (tracing off must not serialize the hot path)
                    self._solve_one(entry)
                    continue
                base = ffd.solver_cache_counters()
                # explain-off adds ZERO work and ZERO attrs to the solve
                # span — the provenance ledger only meters when capturing
                ledger = explmod.recorder()
                explain_base = ledger.counters() if ledger.enabled else None
                reg = kobs.registry()
                recompiles_base = reg.steady_recompiles()
                t0 = time.perf_counter()
                with ktime.measure() as kernels:
                    err = self._solve_one(entry)
                    if err is not None:
                        span.fail(err)
                solve_wall = time.perf_counter() - t0
                delta = {
                    name: value - base.get(name, 0)  # port: a counter born in the solve
                    for name, value in ffd.solver_cache_counters().items()
                }
                if not mem_live:
                    mem_live.append(
                        kobs.sample_device_memory()["live_array_bytes"]
                    )
                # host-stall attribution per solve (efficiency observatory):
                # the fenced device wall vs this solve's total wall — the
                # per-request twin of the batch scope's timeline, with the
                # same attribution rule (a compile's wall is host-side XLA
                # work, never device-busy). Volatile: wall measurements
                # never enter the deterministic export.
                device_busy = kernels["execute_s"]
                host_stall = (
                    round(min(1.0, max(0.0, 1.0 - device_busy / solve_wall)), 6)
                    if solve_wall > 0
                    else None
                )
                span.set_volatile(
                    wall_compile_s=round(kernels["compile_s"], 6),
                    wall_execute_s=round(kernels["execute_s"], 6),
                    wall_enqueue_s=round(kernels["enqueue_s"], 6),
                    wall_block_s=round(kernels["block_s"], 6),
                    host_stall_fraction=host_stall,
                    kernel_dispatches=kernels["dispatches"],
                    kernel_compiles=kernels["compiles"],
                    kernel_recompiles=reg.steady_recompiles() - recompiles_base,
                    device_live_array_bytes=mem_live[0],
                    **delta,
                )
                if explain_base is not None:
                    now_ctr = ledger.counters()
                    span.set_volatile(
                        explain_committed=now_ctr["explain_committed"]
                        - explain_base["explain_committed"],
                        explain_ring_depth=now_ctr["explain_ring_depth"],
                    )

    @staticmethod
    def _solve_one(entry):
        """Run one entry's solve, filling result/error; returns the error
        (the request fails, the batch continues)."""
        req = entry.request
        try:
            with measure(_SOLVE_LATENCY, {"kind": req.kind}):
                entry.result = req.scheduler.solve(req.pods, timeout=req.timeout)
            # solve-completion barrier for the provenance ledger: commit an
            # entry per still-failed pod (provisioning solves only — the
            # simulate kind clears staging without polluting the triage
            # table). No-op when --explain is off.
            explmod.recorder().commit_solve(
                req.pods, entry.result.pod_errors, kind=req.kind
            )
        except Exception as err:  # noqa: BLE001 — fail the one request
            entry.error = err
            return err
        return None

    def _prime(self, entries: list) -> None:
        from karpenter_tpu_torch.ops import ffd

        tracer = tracing.tracer()
        buckets: dict[int, tuple[object, list]] = {}
        for entry in entries:
            engine = getattr(entry.request.scheduler, "engine", None)
            if engine is None:
                continue
            buckets.setdefault(id(engine), (engine, []))[1].append(entry)
        for engine, bucket in buckets.values():
            if len(bucket) < 2:
                continue
            # the leader's trace owns the shared sweep; riders are counted
            # in the attrs (their own solve spans see the warm cache)
            ctx = tracer.context_from(
                getattr(bucket[0].request, "trace_context", None)
            )
            with tracer.span(
                "solverd.coalesce", parent=ctx, requests=len(bucket)
            ) as span:
                try:
                    # frontier-tagged groups whose pod sets NEST (multi-node
                    # prefix probes, request.group_nested) collect from
                    # their largest member only — its row-sets cover the
                    # whole group, so the per-member grouping work
                    # telescopes away. Disjoint groups (single-node probe
                    # batches) still collect per member: their siblings'
                    # row-sets are NOT subsets of anyone's.
                    groups: dict[str, list] = {}
                    singles: list = []
                    for entry in bucket:
                        tag = getattr(entry.request, "group", None)
                        if tag is not None:
                            groups.setdefault(tag, []).append(entry)
                        else:
                            singles.append(entry)
                    pairs = []
                    for members in groups.values():
                        if all(
                            getattr(e.request, "group_nested", False)
                            for e in members
                        ):
                            pairs.extend(
                                ffd.collect_prefix_rowsets(
                                    [
                                        (e.request.scheduler, e.request.pods)
                                        for e in members
                                    ]
                                )
                            )
                        else:
                            for e in members:
                                pairs.extend(
                                    ffd.collect_joint_rowsets(
                                        e.request.scheduler, e.request.pods
                                    )
                                )
                        _FRONTIER_GROUPS.inc()
                    for entry in singles:
                        pairs.extend(
                            ffd.collect_joint_rowsets(
                                entry.request.scheduler, entry.request.pods
                            )
                        )
                    primed = 0
                    if pairs:
                        primed = ffd.prime_joint_masks(engine, pairs)
                        if primed:
                            _PRIMED.inc(value=float(primed))
                    _COALESCED.inc(value=float(len(bucket)))
                    span.set_volatile(
                        primed=primed,
                        rowsets=len(pairs),
                        frontier_groups=len(groups),
                    )
                except KernelError as e:
                    # port: a device fault fails the batch's requests — the
                    # host must not compute the masks the sweep was to make
                    span.fail(e)
                    for entry in bucket:
                        entry.error = e
                    raise
                except Exception as e:  # noqa: BLE001 — priming is an
                    # optimization; the solves below are exact without it
                    span.fail(e)
