"""SolverService: the solver daemon's core — admission, coalescing window,
batch execution.

Concurrency model is leader/follower, the batching discipline the
provisioner's Batcher applies to pods lifted to solve requests: the first
caller into an idle service becomes the batch leader, holds the coalescing
window open (idle-window semantics — clock.sleep, so FakeClock tests pay no
real time), then drains the admission queue and executes everything that
arrived as ONE coalesced batch. Callers that arrive while a batch executes
queue for the next one; callers past the queue depth or their deadline are
shed with typed rejections (api.py) instead of blocking the controller
loop.

The service is transport-agnostic: the in-process client calls solve()
directly on the operator thread (window 0 → identical behavior to calling
scheduler.solve, minus nothing), and the socket daemon calls it from one
thread per connection — which is exactly how concurrent clients coalesce.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Optional

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.solverd.api import (
    DrainingError,
    SolveRequest,
    SolverClosedError,
    SolverRejection,
)
from karpenter_tpu_torch.solverd.coalescer import Coalescer
from karpenter_tpu_torch.solverd.queue import AdmissionQueue
from karpenter_tpu_torch.utils.clock import Clock

_REQUESTS = global_registry.counter(
    "karpenter_solverd_requests_total",
    "solve requests admitted",
    labels=["kind"],
)
_BATCH_SIZE = global_registry.histogram(
    "karpenter_solverd_batch_size",
    "requests per coalesced batch",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128),
)
_QUEUE_LATENCY = global_registry.histogram(
    "karpenter_solverd_queue_latency_seconds",
    "admission-to-execution wait per request",
)
_DEDUP_HITS = global_registry.counter(
    "karpenter_solverd_dedup_hits_total",
    "replayed solve requests answered from the request-id dedup record "
    "instead of being admitted (and executed) a second time",
)


class _Entry:
    __slots__ = ("request", "result", "error", "event", "enqueued_at", "done")

    def __init__(self, request: SolveRequest):
        self.request = request
        self.result = None
        self.error: Optional[Exception] = None
        self.event = threading.Event()
        self.enqueued_at = 0.0
        self.done = False

    def finish(self) -> None:
        self.done = True
        self.event.set()


class _Completed:
    """A finished solve's lightweight dedup record: same result/error/done
    surface as a finished _Entry, without keeping the request (and its
    scheduler graph) alive. A replayed request id resolves to this and
    returns immediately — never re-admitted, never re-executed."""

    __slots__ = ("result", "error")
    done = True

    def __init__(self, result, error):
        self.result = result
        self.error = error


# completed dedup records kept per service; the records are tiny (result +
# error references) but the cap bounds result-graph retention too
_DEDUP_CAP = 1024


class SolverService:
    def __init__(
        self,
        clock: Optional[Clock] = None,
        max_queue_depth: int = 256,
        coalesce_window: float = 0.0,
        coalescer: Optional[Coalescer] = None,
        tenant_quota: int = 0,
        tenant_weights: Optional[dict] = None,
    ):
        self.clock = clock or Clock()
        self.queue = AdmissionQueue(
            self.clock,
            max_depth=max_queue_depth,
            tenant_quota=tenant_quota,
            tenant_weights=tenant_weights,
        )
        self.coalescer = coalescer or Coalescer()
        self.coalesce_window = coalesce_window
        self._lock = threading.Lock()
        self._executing = False
        self._closed = False
        self._draining = False
        # request-id dedup: in-flight entries so a replay attaches to the
        # original admission, completed records so a replay of a finished
        # solve answers from the record. Bounded FIFO eviction of completed
        # records only — in-flight entries are pinned (and bounded by the
        # admission queue anyway).
        self._dedup: OrderedDict[str, object] = OrderedDict()
        self._dedup_lock = threading.Lock()
        # executed request ids (bounded): the fleet sim's zero-double-execute
        # audit reads this; {} once the cap trips (audit reports overflow)
        self.executed_ids: dict[str, int] = {}
        self.executed_ids_overflow = False
        # cumulative stats for /debug/solverd (metrics carry the
        # histograms). Mutated and snapshotted only under _stats_lock so a
        # concurrent /debug/solverd read sees a mutually consistent set —
        # e.g. `executed` never exceeds `requests`, `batches` never exceeds
        # `executed` — instead of counters torn mid-batch.
        self._stats_lock = threading.Lock()
        self.batches = 0
        self.requests = 0
        self.executed = 0
        self.rejected = 0
        self.cancelled = 0
        self.deduped = 0
        self.max_batch_size = 0
        self.last_batch_seconds = 0.0
        self.last_batch_dispatches = 0
        self.last_batch_host_stall: Optional[float] = None

    # -- client surface ------------------------------------------------------

    def submit(self, request: SolveRequest):
        """Admit a request; raises a typed SolverRejection when shed. The
        returned entry completes on a later run_pending()/solve() drain.

        Replay dedup: a request id already known — in flight or completed —
        returns the ORIGINAL entry (or its completed record) without
        touching the admission queue, so a transport replay (reconnect
        after a dropped connection, pool failover back to this replica) can
        never admit or execute the same solve twice."""
        if self._closed:
            raise SolverClosedError("solver service is closed")
        rid = request.request_id
        if rid:
            with self._dedup_lock:
                known = self._dedup.get(rid)
            if known is not None:
                with self._stats_lock:
                    self.deduped += 1
                _DEDUP_HITS.inc()
                return known
        from karpenter_tpu_torch.observability import slo

        if self._draining:
            with self._stats_lock:
                self.rejected += 1
            from karpenter_tpu_torch.solverd.queue import _REJECTIONS

            _REJECTIONS.inc({"reason": "draining"})
            # draining is NOT an admission-SLO violation: the fleet client
            # fails the request over to a healthy replica — no slo feed
            raise DrainingError(
                "solver service is draining; replay on another replica"
            )
        entry = _Entry(request)
        try:
            self.queue.offer(entry)
        except Exception:
            with self._stats_lock:
                self.rejected += 1
            # per-tenant admission SLO: the request was shed (queue full,
            # deadline, tenant quota) — attributed by the tenant tag every
            # SolveRequest carries (PR 9), aggregate when untagged
            slo.engine().record(
                "solverd-admission", bad=1, tenant=request.tenant,
                now=self.clock.now(),
            )
            raise
        slo.engine().record(
            "solverd-admission", good=1, tenant=request.tenant,
            now=self.clock.now(),
        )
        if rid:
            with self._dedup_lock:
                self._dedup[rid] = entry
                while len(self._dedup) > _DEDUP_CAP:
                    # evict oldest COMPLETED record; in-flight entries stay
                    for key in self._dedup:
                        if isinstance(self._dedup[key], _Completed):
                            del self._dedup[key]
                            break
                    else:
                        break
        with self._stats_lock:
            self.requests += 1
        _REQUESTS.inc({"kind": request.kind})
        return entry

    def _seal_dedup(self, entry: _Entry) -> None:
        """Swap a finished entry's dedup slot for its lightweight completed
        record — future replays answer from it, and the request's scheduler
        graph is released."""
        rid = entry.request.request_id
        if not rid:
            return
        with self._dedup_lock:
            if self._dedup.get(rid) is entry:
                self._dedup[rid] = _Completed(entry.result, entry.error)

    def solve(self, request: SolveRequest):
        """Admit + execute, returning the solve's Results (or raising its
        error / a typed rejection). Safe from many threads: one becomes the
        batch leader, the rest ride its batch or the next."""
        entry = self.submit(request)
        while True:
            leader = False
            with self._lock:
                if entry.done:
                    break
                if not self._executing:
                    self._executing = True
                    leader = True
            if leader:
                try:
                    if self.coalesce_window > 0:
                        # hold the window open so concurrent callers land in
                        # this batch; FakeClock steps instead of sleeping
                        self.clock.sleep(self.coalesce_window)
                    self.run_pending()
                finally:
                    with self._lock:
                        self._executing = False
            else:
                # finish() sets the entry's event — precise wakeup when the
                # leader completes it; the short timeout re-checks leadership
                # in case this entry missed the leader's drain
                entry.event.wait(timeout=0.05)
        if entry.error is not None:
            raise entry.error
        return entry.result

    def solve_many(self, requests: list) -> list:
        """Admit + execute a structured batch (e.g. one consolidation
        frontier round), returning the completed entries in request order —
        callers read per-entry `result`/`error` so one failed probe doesn't
        void its siblings' verdicts. All entries land in the admission
        queue before any drain runs, so a single leader executes the whole
        group as ONE coalesced batch. Admission is all-or-nothing: a typed
        rejection mid-group un-admits the already-queued siblings (a
        frontier round is useless in fragments) and re-raises."""
        entries = []
        for request in requests:
            try:
                entries.append(self.submit(request))
            except SolverRejection:
                # cancel only entries THIS call admitted (entry.request is
                # our request object): a dedup hit returns someone else's
                # in-flight entry, and un-admitting it would shed a solve
                # its real owner is still waiting on
                fresh = [
                    e
                    for req, e in zip(requests, entries)
                    if getattr(e, "request", None) is req
                ]
                removed = self.queue.remove(fresh)
                # release the un-admitted entries' dedup slots: they will
                # never finish, so leaving them would wedge a replay of the
                # same ids (attached to entries no drain completes) and pin
                # the eviction queue. Entries a concurrent leader already
                # drained stay — they WILL finish, and a replay must keep
                # attaching to them, not re-admit.
                with self._dedup_lock:
                    for entry in removed:
                        rid = entry.request.request_id
                        if rid and self._dedup.get(rid) is entry:
                            del self._dedup[rid]
                with self._stats_lock:
                    self.cancelled += len(removed)
                raise
        while True:
            leader = False
            with self._lock:
                if all(e.done for e in entries):
                    break
                if not self._executing:
                    self._executing = True
                    leader = True
            if leader:
                try:
                    if self.coalesce_window > 0:
                        self.clock.sleep(self.coalesce_window)
                    self.run_pending()
                finally:
                    with self._lock:
                        self._executing = False
            else:
                # re-scan outside the lock: a concurrent leader may have
                # finished every entry since the locked check — then just
                # loop back to the all-done exit instead of blocking
                pending = next((e for e in entries if not e.done), None)
                if pending is not None:
                    pending.event.wait(timeout=0.05)
        return entries

    # -- execution -----------------------------------------------------------

    def run_pending(self) -> int:
        """Drain the queue and execute one coalesced batch synchronously.
        Returns the number of requests executed."""
        from karpenter_tpu_torch.solverd.api import DeadlineExceededError

        tracer = tracing.tracer()
        ready, expired = self.queue.drain()
        now = self.clock.now()
        for entry in expired:
            with self._stats_lock:
                self.rejected += 1
            err = DeadlineExceededError(
                "deadline passed while queued; request not executed"
            )
            ctx = tracer.context_from(entry.request.trace_context)
            if ctx is not None:
                tracer.event(
                    "solverd.queue", parent=ctx, start=entry.enqueued_at,
                    kind=entry.request.kind, error=err,
                )
            entry.error = err
            entry.finish()
            self._seal_dedup(entry)
        if not ready:
            return 0
        for entry in ready:
            _QUEUE_LATENCY.observe(max(0.0, now - entry.enqueued_at))
            # the admission hop of the caller's trace: enqueue → batch drain
            ctx = tracer.context_from(entry.request.trace_context)
            if ctx is not None:
                tracer.event(
                    "solverd.queue", parent=ctx, start=entry.enqueued_at,
                    kind=entry.request.kind,
                )
        _BATCH_SIZE.observe(float(len(ready)))
        with self._stats_lock:
            self.batches += 1
            self.max_batch_size = max(self.max_batch_size, len(ready))
        started = time.perf_counter()
        from karpenter_tpu_torch.observability import kernels as kobs

        try:
            # per-batch device dispatch accounting: the one-dispatch-solve
            # contract's runtime proof surface (/debug/kernels "batches")
            with kobs.registry().batch_scope(
                label=f"solverd:{len(ready)}"
            ) as batch_acc:
                self.coalescer.execute(ready)
            self.last_batch_dispatches = batch_acc["dispatches"]
            # the batch scope's timeline verdict: where this batch's wall
            # went (1.0 = fully host-paced). Wall-clock — /debug only,
            # never the sim report (same split as last_batch_seconds).
            self.last_batch_host_stall = batch_acc.get("host_stall_fraction")
        finally:
            for entry in ready:
                if entry.result is None and entry.error is None:
                    entry.error = RuntimeError("solve batch aborted")
                rid = entry.request.request_id
                if rid:
                    if len(self.executed_ids) < _DEDUP_CAP:
                        self.executed_ids[rid] = self.executed_ids.get(rid, 0) + 1
                    else:
                        self.executed_ids_overflow = True
                entry.finish()
                self._seal_dedup(entry)
        with self._stats_lock:
            self.executed += len(ready)
            self.last_batch_seconds = time.perf_counter() - started
        # post-batch telemetry: device memory gauges (live-array bytes +
        # per-device allocator stats) and the solver cache counters mirrored
        # onto /metrics — both best-effort, never failing the batch
        try:
            from karpenter_tpu_torch.observability import efficiency
            from karpenter_tpu_torch.observability import kernels as kobs
            from karpenter_tpu_torch.ops import ffd

            kobs.sample_device_memory()
            ffd.publish_cache_counters()
            # utilization gauges (cost-model floor / measured execute wall)
            # refresh from the batch's fenced measurements; a no-op until
            # an AOT warm start built cost tables
            efficiency.publish_utilization()
        except Exception:  # noqa: BLE001 — telemetry must not fail solves
            pass
        return len(ready)

    def drain(self) -> None:
        """Enter draining mode: in-flight and already-admitted work finishes,
        every new submit is refused with a typed DrainingError (shed, never
        block). The daemon's SIGTERM path calls this, waits for
        quiesced(), then exits."""
        with self._lock:
            self._draining = True

    @property
    def draining(self) -> bool:
        return self._draining

    def quiesced(self) -> bool:
        """Nothing queued and no batch executing — safe to exit."""
        with self._lock:
            executing = self._executing
        return not executing and self.queue.depth() == 0

    def close(self) -> None:
        with self._lock:
            self._closed = True
        # the daemon is exiting: its device residencies (ops/delta.py) die
        # with the process — drop them now so the resident-bytes gauge and
        # a post-close /debug read never claim state that no longer serves
        from karpenter_tpu_torch.ops import delta as delta_mod

        delta_mod.invalidate_all("service-close")
        # fail anything still queued rather than stranding its waiters
        ready, expired = self.queue.drain()
        for entry in ready + expired:
            entry.error = SolverClosedError("solver service closed")
            entry.finish()
            self._seal_dedup(entry)

    def stats(self) -> dict:
        from karpenter_tpu_torch.ops import delta, ffd

        # snapshot under the stats lock: every counter in the result comes
        # from one atomic read, so invariants (executed <= requests,
        # batches <= executed) hold in every snapshot a concurrent
        # /debug/solverd reader takes
        with self._stats_lock:
            counters = {
                "requests": self.requests,
                "batches": self.batches,
                "executed": self.executed,
                "rejected": self.rejected,
                "cancelled": self.cancelled,
                "deduped": self.deduped,
                "max_batch_size": self.max_batch_size,
                "last_batch_seconds": self.last_batch_seconds,
                "last_batch_dispatches": self.last_batch_dispatches,
                "last_batch_host_stall": self.last_batch_host_stall,
            }
        return {
            "transport": "inprocess",
            "queue_depth": self.queue.depth(),
            "queue_cap": self.queue.max_depth,
            "tenant_quota": self.queue.tenant_quota,
            "tenant_depths": self.queue.tenant_depths(),
            "draining": self._draining,
            "coalesce_window": self.coalesce_window,
            **counters,
            "joint_sweeps": ffd.JOINT_SWEEPS,
            "device_solves": ffd.DEVICE_SOLVES,
            "device_fallbacks": ffd.DEVICE_FALLBACKS,
            "delta": delta.delta_counters(),
        }
