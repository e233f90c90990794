"""solverd fleet: N daemon replicas behind one pool-aware SolverClient.

The last single point of failure in the serving path was the one solverd
daemon — one process crash and every controller degraded to shed-everything
until it returned. The FleetClient grows that daemon into a pool, mirroring
the reference's replicated-operator availability story (leader-elected
instances, pkg/operator/operator.go:144-151) one level down the stack:

* **Client-side health-checked failover.** Every replica sits behind its
  own closed→open→half-open CircuitBreaker (the same machine the
  cloud-provider breaker in cloudprovider/breaker.py runs,
  operator/harness.py): consecutive transport failures open the breaker and
  the replica drops out of rotation until a cooldown probe passes. There is
  no leader election — any replica can serve any solve, so the pool
  degrades gracefully under any one-replica loss.

* **Catalog content-hash affinity routing.** Solves are routed by
  rendezvous hashing over (tenant, catalog content hash) so one tenant's
  catalog keeps hitting the replica whose engines and AOT executables are
  already warm for it; when that replica is unhealthy the hash order names
  the next-warmest candidate deterministically.

* **In-flight replay with request-id dedup.** A solve interrupted by
  connection loss is replayed on the next healthy replica under the SAME
  request id; the service-side dedup (service.py) guarantees a replay that
  races its original — or lands back on a replica that already executed it
  — attaches to the original admission instead of admitting twice.

* **Tenant fairness.** Quotas and weighted fair ordering live in the
  admission queue (queue.py); the fleet client stamps every request with
  its tenant so a noisy cluster is shed by its own quota while quiet ones
  keep their headroom on every replica.

* **Pipelined admission.** AdmissionPipeline double-buffers a stream of
  solve batches: the host-side encode of batch N+1 (the wire pickle on the
  socket transport) runs on a background thread while batch N executes on
  the device, and the overlap is measured so the bench can prove how much
  encode wall the pipeline hides.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Optional, Sequence

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator.harness import CircuitBreaker
from karpenter_tpu_torch.solverd import api
from karpenter_tpu_torch.solverd.api import TransportError, should_failover
from karpenter_tpu_torch.solverd.transport import SolverClient
from karpenter_tpu_torch.utils.clock import Clock

_HEALTHY = global_registry.gauge(
    "karpenter_solverd_fleet_healthy_replicas",
    "replicas whose circuit breaker currently admits traffic",
)
_REPLICA_STATE = global_registry.gauge(
    "karpenter_solverd_fleet_replica_state",
    "per-replica breaker state (0 closed, 1 half-open, 2 open)",
    labels=["replica"],
)
_FAILOVERS = global_registry.counter(
    "karpenter_solverd_fleet_failovers_total",
    "solves re-routed off a replica mid-request",
    labels=["from", "reason"],
)
_REPLAYS = global_registry.counter(
    "karpenter_solverd_fleet_replays_total",
    "in-flight requests replayed on another replica after connection loss",
)
_SOLVES = global_registry.counter(
    "karpenter_solverd_fleet_solves_total",
    "solves served, by the replica that answered",
    labels=["replica"],
)
_STATE_VALUES = {
    CircuitBreaker.CLOSED: 0.0,
    CircuitBreaker.HALF_OPEN: 1.0,
    CircuitBreaker.OPEN: 2.0,
}

_ENCODE_WALL = global_registry.counter(
    "karpenter_solverd_pipeline_encode_seconds_total",
    "host-side encode wall spent preparing solve batches",
)
_ENCODE_HIDDEN = global_registry.counter(
    "karpenter_solverd_pipeline_hidden_seconds_total",
    "encode wall that overlapped device execution of the previous batch",
)


class _Replica:
    """One pool member: the transport client plus this FleetClient's local
    health view of it. Breakers are client-side state — two operators
    pointed at the same pool each probe independently, exactly like two
    kubelets watching one apiserver endpoint."""

    __slots__ = ("replica_id", "client", "breaker", "clock", "draining_until",
                 "solves")

    def __init__(self, replica_id: str, client: SolverClient,
                 breaker: CircuitBreaker, clock: Clock):
        self.replica_id = replica_id
        self.client = client
        self.breaker = breaker
        self.clock = clock
        # a replica that answered Draining/Closed is alive but going away:
        # route around it for one cooldown window, then probe again. The
        # WINDOW ends the exile, not a success — routing never offers a
        # skipped replica the success that would clear a sticky flag, so a
        # drained-and-restarted replica must rejoin by timeout (exactly how
        # the breaker's open state re-probes).
        self.draining_until = 0.0
        self.solves = 0

    @property
    def draining(self) -> bool:
        return self.clock.now() < self.draining_until


class FleetClient(SolverClient):
    """SolverClient over N replicas with failover, affinity, and replay."""

    transport = "fleet"

    def __init__(
        self,
        replicas: Sequence[tuple[str, SolverClient]],
        clock: Optional[Clock] = None,
        tenant: str = "",
        breaker_threshold: int = 3,
        breaker_cooldown: float = 5.0,
    ):
        if not replicas:
            raise ValueError("a solver fleet needs at least one replica")
        clock = clock or Clock()
        self.clock = clock
        self.breaker_cooldown = breaker_cooldown
        self.tenant = tenant
        self._replicas = [
            _Replica(
                rid,
                client,
                CircuitBreaker(
                    clock,
                    threshold=breaker_threshold,
                    cooldown=breaker_cooldown,
                    name=rid,
                ),
                clock,
            )
            for rid, client in replicas
        ]
        for replica in self._replicas:
            replica.breaker.subscribe(
                self._on_transition(replica.replica_id)
            )
            _REPLICA_STATE.set(0.0, {"replica": replica.replica_id})
        self._lock = threading.Lock()
        self.failovers = 0
        self.replays = 0
        self.draining_failovers = 0
        self._publish_health()

    # -- health --------------------------------------------------------------

    def _on_transition(self, replica_id: str):
        def callback(old: str, new: str) -> None:
            _REPLICA_STATE.set(_STATE_VALUES[new], {"replica": replica_id})
            self._publish_health()

        return callback

    def _healthy_count(self) -> int:
        return sum(
            1
            for r in self._replicas
            if r.breaker.state != CircuitBreaker.OPEN and not r.draining
        )

    def _publish_health(self) -> None:
        _HEALTHY.set(float(self._healthy_count()))

    # -- routing -------------------------------------------------------------

    @staticmethod
    def _catalog_hash(scheduler) -> str:
        """The affinity half of the routing key: the catalog content hash —
        the identity solverd content-caches engines (and the AOT service
        keys executables) under, memoized on the engine object."""
        engine = getattr(scheduler, "engine", None)
        if engine is None:
            return "no-engine"
        cached = getattr(engine, "_fleet_content_hash", None)
        if cached is None:
            from karpenter_tpu_torch.aot.compiler import content_hash

            cached = content_hash(engine.instance_types)
            engine._fleet_content_hash = cached
        return cached

    def _affinity_key(self, scheduler, tenant: Optional[str]) -> str:
        tenant = self.tenant if tenant is None else tenant
        return f"{tenant}/{self._catalog_hash(scheduler)}"

    def _route(self, key: str) -> list[_Replica]:
        """Rendezvous-hash candidate order for `key`: deterministic, stable
        under membership (killing one replica re-routes only that replica's
        keys), engine-warm (the same key keeps landing on the same replica
        until it becomes unhealthy)."""
        scored = sorted(
            self._replicas,
            key=lambda r: (
                hashlib.sha256(
                    f"{key}@{r.replica_id}".encode()
                ).hexdigest(),
                r.replica_id,
            ),
            reverse=True,
        )
        return scored

    # -- the failover loop ---------------------------------------------------

    def _note_failover(self, replica: _Replica, err: Exception) -> None:
        """Book-keep one failed-over attempt: breaker/draining state, the
        failover counters, and the failover span in the caller's trace."""
        reason = type(err).__name__
        if isinstance(err, TransportError):
            replica.breaker.record_failure()
        else:
            # Draining/Closed: the process answered — the transport is
            # fine — but it is exiting; route away for one cooldown
            # window, then probe again (see _Replica.draining)
            replica.draining_until = (
                replica.clock.now() + self.breaker_cooldown
            )
            with self._lock:
                self.draining_failovers += 1
            self._publish_health()
        with self._lock:
            self.failovers += 1
        _FAILOVERS.inc({"from": replica.replica_id, "reason": reason})
        # SLO feed: a solve that had to leave its routed replica — the
        # fleet's failover-rate objective, attributed to this tenant
        from karpenter_tpu_torch.observability import slo

        slo.engine().record("solverd-failover", bad=1, tenant=self.tenant)
        tracing.tracer().event(
            "solverd.failover",
            **{"from": replica.replica_id, "reason": reason},
        )

    def _note_success(self, replica: _Replica) -> None:
        replica.breaker.record_success()
        if replica.draining_until:
            replica.draining_until = 0.0
            self._publish_health()
        replica.solves += 1
        _SOLVES.inc({"replica": replica.replica_id})
        from karpenter_tpu_torch.observability import slo

        slo.engine().record("solverd-failover", good=1, tenant=self.tenant)

    def _attempt(self, key: str, call, exclude=None, prior_error=None):
        """Run `call(replica)` against the candidate order for `key`,
        failing over on transport loss / going-away rejections and
        re-raising everything else from the replica that answered. The
        caller passes the SAME request id into every attempt, so a replay
        can never double-admit. `exclude` skips a replica that already
        failed this request and `prior_error` carries its failure (the
        in-flight begin/finish path): the first attempt here is then a
        replay, and if no sibling is admissible the prior error — the real
        cause — is what the exhaustion raise chains."""
        candidates = self._route(key)
        last_err: Optional[Exception] = prior_error
        attempted = 0
        for replica in candidates:
            if replica is exclude:
                continue
            if replica.draining or not replica.breaker.allow():
                continue
            attempted += 1
            if last_err is not None:
                # an earlier replica lost this request mid-flight (or turned
                # us away while exiting): this attempt is a replay
                with self._lock:
                    self.replays += 1
                _REPLAYS.inc()
            try:
                result = call(replica)
            except Exception as err:  # noqa: BLE001 — classified below
                if not should_failover(err):
                    # the replica is alive and answered: backpressure
                    # (queue full / deadline / tenant quota) and solve
                    # outcomes surface to the caller untouched
                    replica.breaker.record_success()
                    raise
                self._note_failover(replica, err)
                last_err = err
                continue
            self._note_success(replica)
            return result
        if last_err is not None:
            raise TransportError(
                f"fleet exhausted {attempted} replicas: {last_err}"
            ) from last_err
        raise TransportError(
            f"no healthy replica in a fleet of {len(self._replicas)} "
            "(all breakers open or draining)"
        )

    # -- SolverClient surface ------------------------------------------------

    def encode(self, kind, scheduler, pods, timeout=None, deadline=None,
               request_id=None, tenant=None, trace_carrier=None):
        """Prepared fleet request: the routing key, the pinned request id,
        and the replica-portable prepared frame (all replicas speak the
        same protocol, so one encode serves every failover attempt)."""
        rid = request_id or api.new_request_id()
        inner = self._replicas[0].client.encode(
            kind, scheduler, pods, timeout, deadline,
            request_id=rid,
            tenant=self.tenant if tenant is None else tenant,
            trace_carrier=trace_carrier,
        )
        return (self._affinity_key(scheduler, tenant), rid, inner)

    def solve_prepared(self, prepared):
        key, _rid, inner = prepared
        return self._attempt(
            key, lambda replica: replica.client.solve_prepared(inner)
        )

    def solve_begin(self, prepared):
        """In-flight pipelining through the pool: begin on the affinity
        replica (its transport sends the frame now), remembering which
        replica holds the request so a finish-side failure fails over to
        the siblings with the same request id."""
        key, _rid, inner = prepared
        for replica in self._route(key):
            if replica.draining or not replica.breaker.allow():
                continue
            return (key, inner, replica, replica.client.solve_begin(inner))
        # no healthy replica right now: defer to finish, whose _attempt
        # raises the typed no-healthy-replica answer (or succeeds if a
        # breaker's cooldown elapses in between)
        return (key, inner, None, None)

    def solve_finish(self, token):
        key, inner, replica, handle = token
        if replica is None:
            return self._attempt(
                key, lambda r: r.client.solve_prepared(inner)
            )
        try:
            result = replica.client.solve_finish(handle)
        except Exception as err:  # noqa: BLE001 — classified below
            if not should_failover(err):
                replica.breaker.record_success()
                raise
            self._note_failover(replica, err)
            # the frame may have executed before the reply was lost: the
            # replay (same request id) is dedup-safe wherever it lands
            return self._attempt(
                key,
                lambda r: r.client.solve_prepared(inner),
                exclude=replica,
                prior_error=err,
            )
        self._note_success(replica)
        return result

    def solve_many(self, kind, batch, timeout=None, deadline=None, group=None,
                   nested=False, request_ids=None, tenant=None):
        batch = list(batch)
        if not batch:
            return []
        # the whole group routes (and fails over) as one unit so a frontier
        # round still coalesces into ONE device batch on whichever replica
        # serves it; ids are pinned before the first attempt so a replayed
        # group dedups per item
        ids = request_ids or [api.new_request_id() for _ in batch]
        key = self._affinity_key(batch[0][0], tenant)
        return self._attempt(
            key,
            lambda replica: replica.client.solve_many(
                kind, batch, timeout, deadline, group=group, nested=nested,
                request_ids=ids,
                tenant=self.tenant if tenant is None else tenant,
            ),
        )

    def stats(self) -> dict:
        """Client-side pool view — breaker states and counters only, no
        RPC: stats feeds the operator's per-pass health refresh, which must
        never block on (or hammer) a daemon that is down."""
        with self._lock:
            counters = {
                "failovers": self.failovers,
                "replays": self.replays,
                "draining_failovers": self.draining_failovers,
            }
        replicas = [
            {
                "id": r.replica_id,
                "breaker": r.breaker.state,
                "draining": r.draining,
                "solves": r.solves,
            }
            for r in self._replicas
        ]
        healthy = self._healthy_count()
        out = {
            "transport": "fleet",
            "tenant": self.tenant,
            "replicas": replicas,
            "healthy_replicas": healthy,
            **counters,
        }
        if healthy == 0:
            out["error"] = "no healthy replica (all breakers open/draining)"
        return out

    def close(self) -> None:
        for replica in self._replicas:
            try:
                replica.client.close()
            except Exception:  # noqa: BLE001 — close the rest regardless
                pass


class AdmissionPipeline:
    """Double-buffered admission over any SolverClient: encode batch N+1
    while batch N is in flight on the daemon.

    The naive loop serializes the host-side encode (the wire pickle on the
    socket transport) behind the previous batch's execution — every batch
    pays encode + execute end to end. The pipeline overlaps them with the
    transport's begin/finish split: send frame N (`solve_begin`), encode
    batch N+1 while the daemon's process executes N on the device, then
    collect N's reply (`solve_finish`) and send N+1. Single-threaded by
    design — the overlap is between THIS process's encode and the OTHER
    process's execute, so no GIL is contended (a threaded encode stalls
    behind the reply decode's GIL hold; this shape cannot).

    `encode_overlap_fraction` is the share of total encode wall spent while
    a batch was in flight (between its send and its reply) — the quantity
    the fleet bench leg reports and the perf floor asserts ≥ 0.5. The
    `post_encode_wait_s` companion is the wall finish() still took AFTER
    the encode completed (reply wait + decode) — the pipeline's remaining
    serial tail."""

    def __init__(self, client: SolverClient):
        self.client = client
        self._reset()

    def _reset(self) -> None:
        self.encode_wall = 0.0
        self.execute_wall = 0.0
        self.hidden_wall = 0.0
        self.post_encode_wait = 0.0
        self.batches = 0

    def stats(self) -> dict:
        total = self.encode_wall
        return {
            "batches": self.batches,
            "encode_wall_s": round(self.encode_wall, 6),
            "execute_wall_s": round(self.execute_wall, 6),
            "hidden_encode_s": round(self.hidden_wall, 6),
            "post_encode_wait_s": round(self.post_encode_wait, 6),
            "encode_overlap_fraction": (
                round(self.hidden_wall / total, 6) if total > 0 else 0.0
            ),
        }

    def run(
        self,
        kind: str,
        stream: Sequence[tuple],
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        pipelined: bool = True,
    ) -> list[tuple]:
        """Drive `stream` ([(scheduler, pods), ...]) through the client,
        one solve per item, returning per-item (result, error) in order.
        `pipelined=False` runs the identical encode→execute sequence
        strictly serialized — the bench's control leg."""
        self._reset()
        stream = list(stream)
        if not stream:
            return []
        tracer = tracing.tracer()
        carrier = tracer.carrier()

        def encode(index: int) -> tuple:
            t0 = time.perf_counter()
            try:
                prepared = self.client.encode(
                    kind, stream[index][0], stream[index][1],
                    timeout, deadline, trace_carrier=carrier,
                )
                err = None
            except Exception as e:  # noqa: BLE001 — per-item error slots
                prepared, err = None, e
            self.encode_wall += time.perf_counter() - t0
            return prepared, err, time.perf_counter() - t0

        def finish(token) -> tuple:
            x0 = time.perf_counter()
            try:
                out = (self.client.solve_finish(token), None)
            except Exception as err:  # noqa: BLE001 — per-item error slots
                out = (None, err)
            self.execute_wall += time.perf_counter() - x0
            self.batches += 1
            return out

        out: list[tuple] = []
        with tracer.span(
            "solverd.pipeline", batches=len(stream), pipelined=pipelined
        ) as span:
            if not pipelined:
                for index in range(len(stream)):
                    prepared, err, _dur = encode(index)
                    if err is not None:
                        out.append((None, err))
                        self.batches += 1
                        continue
                    out.append(finish(self.client.solve_begin(prepared)))
            else:
                prepared, err, _dur = encode(0)
                inflight = None
                if err is not None:
                    out.append((None, err))
                    self.batches += 1
                else:
                    inflight = self.client.solve_begin(prepared)
                for index in range(1, len(stream) + 1):
                    nxt = encode(index) if index < len(stream) else None
                    if inflight is not None:
                        # everything the encode above cost ran while this
                        # request was in flight: hidden wall. The residual
                        # wait inside finish() proves the daemon was still
                        # busy when the encode ended.
                        if nxt is not None:
                            self.hidden_wall += nxt[2]
                        w0 = time.perf_counter()
                        out.append(finish(inflight))
                        self.post_encode_wait += time.perf_counter() - w0
                        inflight = None
                    if nxt is not None:
                        prepared, err, _dur = nxt
                        if err is not None:
                            out.append((None, err))
                            self.batches += 1
                        else:
                            inflight = self.client.solve_begin(prepared)
            _ENCODE_WALL.inc(value=self.encode_wall)
            _ENCODE_HIDDEN.inc(value=self.hidden_wall)
            span.set_volatile(**self.stats())
        return out
