"""solverd transports: one client interface, two implementations.

In-process (default): the client calls the SolverService directly — zero
copy, the operator loop's solves and simulations go through the same
admission/coalescing discipline with no serialization.

Socket (sidecar mode): a length-prefixed JSON protocol over TCP or a unix
socket. Each frame is a 4-byte big-endian length followed by a JSON
envelope; the solve state (scheduler, pods, catalog) rides inside the
envelope as a base64 pickle — JSON carries the control plane (op, kind,
timeout, deadline, typed error identity) so rejections stay typed across
the wire without unpickling arbitrary exceptions.

TRUST MODEL: the payload pickle means deserialization executes code on the
receiving side, and the protocol carries no authentication. Both ends must
trust each other fully — the supported deployment is a unix socket or
loopback TCP between an operator and its sidecar on the same host/pod; the
daemon logs a warning when bound to a non-loopback address.

The daemon owns the accelerator: clients strip their CatalogEngine before
pickling (device arrays don't travel) and send the catalog's instance
types instead; the daemon rebuilds/content-caches an engine per distinct
catalog and attaches it before solving. Decisions are transport-invariant
by construction — the device path reproduces the host loop bit-for-bit
(ops/ffd.py), so whether an engine attaches on the client, the daemon, or
not at all, the node decisions are identical.
"""

from __future__ import annotations

import base64
import json
import pickle
import socket
import struct
import threading
import time
from contextlib import contextmanager
from typing import Optional

from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.solverd import api
from karpenter_tpu_torch.solverd.api import SolveRequest, TransportError
from karpenter_tpu_torch.solverd.service import SolverService

WIRE_VERSION = 1
_MAX_FRAME = 256 * 1024 * 1024  # defensive cap on frame length

# typed rejections cross the wire by NAME so the client re-raises the same
# class the in-process transport would
_ERROR_TYPES = {
    cls.__name__: cls
    for cls in (
        api.SolverRejection,
        api.QueueFullError,
        api.DeadlineExceededError,
        api.SolverClosedError,
        api.DrainingError,
        api.TenantQuotaExceededError,
        # port: a daemon-side device fault reaches the client as the
        # KernelError it is, not as a TransportError a caller backs off on
        KernelError,
    )
}


class SolverClient:
    """The one interface every transport implements.

    `tenant` names the requesting cluster on every request (per-tenant
    quotas and fairness are enforced service-side). `request_id` — minted
    per solve unless the caller (a pool client replaying onto another
    replica) supplies one — makes retries dedup-safe.

    encode()/solve_prepared() split a solve into its host-side encode
    (building the wire frame: the pickle on the socket transport) and the
    round trip that executes it, so an admission pipeline can encode batch
    N+1 while batch N executes on the device. `solve(args...)` is always
    `solve_prepared(encode(args...))`."""

    transport = "none"
    tenant = ""

    def solve(
        self,
        kind: str,
        scheduler,
        pods,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
    ):
        return self.solve_prepared(
            self.encode(
                kind, scheduler, pods, timeout, deadline,
                request_id=request_id, tenant=tenant,
            )
        )

    def encode(
        self,
        kind: str,
        scheduler,
        pods,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        request_id: Optional[str] = None,
        tenant: Optional[str] = None,
        trace_carrier: Optional[dict] = None,
    ):
        """Host-side encode: everything that can be prepared without the
        device or the wire. Returns an opaque prepared request for
        solve_prepared(). The base/in-process prepared form is just the
        captured arguments — there is no serialization to front-run."""
        raise NotImplementedError

    def solve_prepared(self, prepared):
        raise NotImplementedError

    def solve_begin(self, prepared):
        """Start a prepared solve and return an in-flight handle: a
        transport that can leave the request on the wire (the socket
        client) sends the frame now, so the caller can encode the NEXT
        batch while the daemon executes this one, then collect with
        solve_finish(). The base implementation is synchronous — begin is
        a no-op and finish executes — so pipelining degrades gracefully on
        transports with no wire to overlap."""
        return prepared

    def solve_finish(self, handle):
        return self.solve_prepared(handle)

    def solve_many(
        self,
        kind: str,
        batch,
        timeout: Optional[float] = None,
        deadline: Optional[float] = None,
        group: Optional[str] = None,
        nested: bool = False,
        request_ids: Optional[list] = None,
        tenant: Optional[str] = None,
    ) -> list:
        """Run a structured batch of solves — `batch` is [(scheduler, pods),
        ...] — returning per-item (result, error) tuples in order. The
        consolidation frontier submits each round's k prefix probes through
        this so they coalesce into ONE device batch; errors stay per-item
        because the caller walks its decision tree and must only surface
        failures the sequential search would actually have hit. The base
        implementation degrades to sequential solves for transports without
        a batched path — decisions are identical, only coalescing is lost."""
        out = []
        batch = list(batch)
        ids = request_ids or [None] * len(batch)
        for (scheduler, pods), rid in zip(batch, ids):
            try:
                out.append(
                    (
                        self.solve(
                            kind, scheduler, pods, timeout, deadline,
                            request_id=rid, tenant=tenant,
                        ),
                        None,
                    )
                )
            except Exception as err:  # noqa: BLE001 — per-item error slots
                out.append((None, err))
        return out

    def stats(self) -> dict:
        return {"transport": self.transport}

    def close(self) -> None:
        pass


class InProcessClient(SolverClient):
    transport = "inprocess"

    def __init__(self, service: SolverService, tenant: str = ""):
        self.service = service
        self.tenant = tenant

    def encode(self, kind, scheduler, pods, timeout=None, deadline=None,
               request_id=None, tenant=None, trace_carrier=None):
        from karpenter_tpu_torch import tracing

        return SolveRequest(
            kind=kind,
            scheduler=scheduler,
            pods=list(pods),
            timeout=timeout,
            deadline=deadline,
            # the caller's span context rides the request so the
            # service-side queue/coalesce/solve spans join its trace
            # even when another thread's batch leader executes them
            trace_context=(
                trace_carrier
                if trace_carrier is not None
                else tracing.tracer().carrier()
            ),
            request_id=request_id or api.new_request_id(),
            tenant=self.tenant if tenant is None else tenant,
        )

    def solve_prepared(self, prepared):
        return self.service.solve(prepared)

    def solve_many(self, kind, batch, timeout=None, deadline=None, group=None,
                   nested=False, request_ids=None, tenant=None):
        from karpenter_tpu_torch import tracing

        carrier = tracing.tracer().carrier()
        batch = list(batch)
        ids = request_ids or [api.new_request_id() for _ in batch]
        entries = self.service.solve_many(
            [
                SolveRequest(
                    kind=kind,
                    scheduler=scheduler,
                    pods=list(pods),
                    timeout=timeout,
                    deadline=deadline,
                    trace_context=carrier,
                    group=group,
                    group_nested=nested,
                    request_id=rid,
                    tenant=self.tenant if tenant is None else tenant,
                )
                for (scheduler, pods), rid in zip(batch, ids)
            ]
        )
        return [(e.result, e.error) for e in entries]

    def stats(self) -> dict:
        return self.service.stats()

    def close(self) -> None:
        self.service.close()


# -- framing ------------------------------------------------------------------


def send_frame(sock: socket.socket, msg: dict) -> None:
    data = json.dumps(msg).encode()
    sock.sendall(struct.pack(">I", len(data)) + data)


def recv_frame(sock: socket.socket) -> Optional[dict]:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > _MAX_FRAME:
        raise TransportError(f"frame length {length} exceeds cap")
    data = _recv_exact(sock, length)
    if data is None:
        raise TransportError("connection closed mid-frame")
    try:
        return json.loads(data)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        # a corrupt payload (bit flip, desynced framing after a partial
        # write) must surface as the same typed, retryable error as a torn
        # frame — the client closes + re-dials + replays, the daemon drops
        # the connection; neither ever sees a raw JSONDecodeError
        raise TransportError(f"malformed frame payload: {e}") from e


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                raise TransportError("connection closed mid-frame")
            return None  # clean EOF between frames
        buf += chunk
    return buf


def _pack(obj) -> str:
    return base64.b64encode(pickle.dumps(obj)).decode("ascii")


def _unpack(payload: str):
    return pickle.loads(base64.b64decode(payload))


def parse_address(address: str) -> tuple[str, object]:
    """"host:port" -> ("tcp", (host, port)); anything else is a unix path."""
    if ":" in address:
        host, _, port = address.rpartition(":")
        return "tcp", (host or "127.0.0.1", int(port))
    return "unix", address


@contextmanager
def _engine_stripped(scheduler):
    """Detach the device engine for pickling; yields it for catalog export."""
    engine = scheduler.engine
    scheduler.engine = None
    try:
        yield engine
    finally:
        scheduler.engine = engine


class SocketClient(SolverClient):
    """Socket transport with reconnect-with-backoff: a daemon restart
    between — or in the middle of — requests is survived by re-dialing
    with exponential backoff and replaying the in-flight frame (solves are
    idempotent: the daemon holds no per-request state). When every attempt
    fails, the caller gets a typed, retryable TransportError promptly
    instead of a hung recv."""

    transport = "socket"

    def __init__(
        self,
        address: str,
        connect_timeout: float = 5.0,
        reconnect_attempts: int = 3,
        backoff_base: float = 0.05,
        backoff_max: float = 1.0,
        sleep=None,
        tenant: str = "",
    ):
        self.address = address
        self.connect_timeout = connect_timeout
        self.reconnect_attempts = max(1, reconnect_attempts)
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self._sleep = sleep if sleep is not None else time.sleep
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        self.reconnects = 0  # cumulative, for stats/tests
        self.tenant = tenant
        self.replica = None  # last replica id seen in a reply

    def _connect(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        family, target = parse_address(self.address)
        try:
            if family == "tcp":
                sock = socket.create_connection(
                    target, timeout=self.connect_timeout
                )
            else:
                sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                sock.settimeout(self.connect_timeout)
                sock.connect(target)
        except OSError as e:
            raise TransportError(f"connect {self.address}: {e}") from e
        sock.settimeout(None)  # solves are long; the daemon bounds them
        self._sock = sock
        return sock

    def _rpc(self, msg: dict, attempts: Optional[int] = None) -> Optional[dict]:
        """Send one frame and await its reply, re-dialing with exponential
        backoff on connection failure. Caller holds the lock."""
        last_err: Optional[Exception] = None
        attempts = self.reconnect_attempts if attempts is None else attempts
        for attempt in range(attempts):
            if attempt > 0:
                self.reconnects += 1
                self._sleep(
                    min(self.backoff_base * (2 ** (attempt - 1)), self.backoff_max)
                )
            try:
                sock = self._connect()
                send_frame(sock, msg)
                reply = recv_frame(sock)
                if reply is None:
                    # daemon closed between frames (restart): retry
                    self._drop()
                    last_err = TransportError("daemon closed the connection")
                    continue
                return reply
            except (OSError, TransportError) as e:
                self._drop()
                last_err = e
        raise TransportError(
            f"solve rpc failed after {attempts} attempts: {last_err}"
        ) from last_err

    def encode(self, kind, scheduler, pods, timeout=None, deadline=None,
               request_id=None, tenant=None, trace_carrier=None):
        """The host-side half of a solve: pack the solve state into the
        wire frame. This is the pickle — the expensive part an admission
        pipeline overlaps with the previous batch's device execution."""
        from karpenter_tpu_torch import tracing

        with _engine_stripped(scheduler) as engine:
            payload = _pack(
                {
                    "scheduler": scheduler,
                    "pods": list(pods),
                    "catalog": list(engine.instance_types) if engine else None,
                }
            )
        return {
            "v": WIRE_VERSION,
            "op": "solve",
            "kind": kind,
            "timeout": timeout,
            # deadlines cross processes as REMAINING seconds — absolute
            # clocks don't agree across the socket
            "deadline_rel": None if deadline is None else max(
                0.0, deadline - scheduler.clock.now()
            ),
            # trace context as plain carrier fields in the JSON control
            # plane: daemon-side spans join the caller's trace without
            # unpickling anything
            "trace": (
                trace_carrier
                if trace_carrier is not None
                else tracing.tracer().carrier()
            ),
            # the id rides the frame itself, so the _rpc replay path (and a
            # pool client re-sending the frame to a sibling replica) repeats
            # it verbatim — the daemon dedups on it
            "request_id": request_id or api.new_request_id(),
            "tenant": self.tenant if tenant is None else tenant,
            "payload": payload,
        }

    @staticmethod
    def _error_from(err: dict) -> Exception:
        """One reply-envelope error dict -> the typed exception the
        in-process transport would have raised."""
        cls = _ERROR_TYPES.get(err.get("type"))
        if cls is not None:
            return cls(err.get("message", ""))
        return TransportError(
            f"daemon error {err.get('type')}: {err.get('message')}"
        )

    def _check_reply(self, reply: dict) -> dict:
        """Shared reply-envelope handling (both solve shapes): import the
        daemon-side spans riding home in the frame (so /debug/traces shows
        one joined trace whichever side of the socket a span was born on),
        record the answering replica, and raise the typed envelope error
        when the frame is a rejection."""
        from karpenter_tpu_torch import tracing

        if reply.get("spans"):
            tracing.tracer().import_spans(reply["spans"])
        if reply.get("replica"):
            self.replica = reply["replica"]
        if not reply.get("ok"):
            raise self._error_from(reply.get("error", {}))
        return reply

    def _decode_reply(self, reply: dict):
        return _unpack(self._check_reply(reply)["payload"])

    def solve_prepared(self, prepared):
        with self._lock:
            reply = self._rpc(prepared)
        return self._decode_reply(reply)

    def solve_begin(self, prepared):
        """The in-flight half of the admission pipeline: send the frame NOW
        and return without waiting — the daemon starts executing in its own
        process while the caller encodes the next batch — then collect the
        reply with solve_finish(). The connection lock is held from begin
        to finish (the pipeline owns the client for that window). A failed
        send is deferred: solve_finish replays through the normal
        reconnect-with-backoff path, dedup-safe under the frame's pinned
        request id."""
        self._lock.acquire()
        handle = {"msg": prepared, "sent": False}
        try:
            sock = self._connect()
            send_frame(sock, prepared)
            handle["sent"] = True
        except (OSError, TransportError):
            self._drop()
        return handle

    def solve_finish(self, handle):
        try:
            reply = None
            if handle["sent"]:
                try:
                    reply = recv_frame(self._sock)
                except (OSError, TransportError):
                    self._drop()
            if reply is None:
                # send failed, daemon closed, or reply lost mid-solve:
                # replay the frame — same request id, so a daemon that
                # already executed it answers from its dedup record
                reply = self._rpc(handle["msg"])
        finally:
            self._lock.release()
        return self._decode_reply(reply)

    def solve_many(self, kind, batch, timeout=None, deadline=None, group=None,
                   nested=False, request_ids=None, tenant=None):
        """Batched solves in ONE frame: the daemon admits the whole group
        before draining, so a frontier round coalesces into a single device
        batch on the far side of the socket exactly as it does in-process.
        Per-item verdicts (result or typed error) ride back in one reply."""
        from karpenter_tpu_torch import tracing

        if not batch:
            return []
        batch = list(batch)
        payloads = []
        clock = batch[0][0].clock
        for scheduler, pods in batch:
            with _engine_stripped(scheduler) as engine:
                payloads.append(
                    _pack(
                        {
                            "scheduler": scheduler,
                            "pods": list(pods),
                            "catalog": list(engine.instance_types)
                            if engine
                            else None,
                        }
                    )
                )
        tracer = tracing.tracer()
        msg = {
            "v": WIRE_VERSION,
            "op": "solve_many",
            "kind": kind,
            "timeout": timeout,
            "deadline_rel": None
            if deadline is None
            else max(0.0, deadline - clock.now()),
            "group": group,
            "nested": bool(nested),
            "trace": tracer.carrier(),
            "request_ids": request_ids
            or [api.new_request_id() for _ in batch],
            "tenant": self.tenant if tenant is None else tenant,
            "payloads": payloads,
        }
        with self._lock:
            reply = self._rpc(msg)
        self._check_reply(reply)
        out = []
        for item in reply.get("results", []):
            if item.get("ok"):
                out.append((_unpack(item["payload"]), None))
            else:
                out.append((None, self._error_from(item.get("error", {}))))
        if len(out) != len(batch):
            raise TransportError(
                f"solve_many reply carried {len(out)} results for "
                f"{len(batch)} requests"
            )
        return out

    def _drop(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def stats(self) -> dict:
        """The daemon's service stats (op=stats RPC) so /debug/solverd shows
        the real queue/batch counters in sidecar mode; falls back to local
        transport info when the daemon is unreachable."""
        out = {
            "transport": "socket",
            "address": self.address,
            "reconnects": self.reconnects,
        }
        if self.replica is not None:
            out["replica"] = self.replica
        with self._lock:
            try:
                # single attempt: the debug path has a graceful fallback, and
                # running the full backoff loop here would pin the lock (and
                # any concurrent solve) for seconds while the daemon is down
                reply = self._rpc({"v": WIRE_VERSION, "op": "stats"}, attempts=1)
            except TransportError as e:
                out["error"] = str(e)
                return out
        if reply and reply.get("ok"):
            if reply.get("replica"):
                self.replica = reply["replica"]
                out["replica"] = reply["replica"]
            daemon_stats = dict(reply.get("stats", {}))
            daemon_stats.update(out)
            return daemon_stats
        return out

    def close(self) -> None:
        with self._lock:
            self._drop()


class SolverDaemon:
    """The sidecar: a socket front-end on a shared SolverService.

    One daemon thread accepts connections; each connection gets a handler
    thread that decodes frames and calls service.solve() — so concurrent
    client connections coalesce into shared device batches exactly like
    concurrent in-process threads. Engines are rebuilt per distinct catalog
    content and cached for the daemon's lifetime."""

    def __init__(
        self,
        service: SolverService,
        address: str = "127.0.0.1:0",
        engine_factory=None,
        replica_id: str = "",
        shard_devices: int = 0,
    ):
        self.service = service
        self.engine_factory = engine_factory or _default_engine_factory(
            shard_devices
        )
        family, target = parse_address(address)
        if family == "tcp" and target[0] not in ("127.0.0.1", "localhost", "::1"):
            # the payload is a pickle: deserializing it executes code, so the
            # protocol carries NO authentication boundary — anyone who can
            # connect can run code as the daemon. Loopback/unix sockets are
            # the supported deployment (operator + daemon share a pod/host).
            from karpenter_tpu_torch.operator import logging as klog

            klog.logger("solverd").warning(
                "binding a non-loopback address: the solve protocol is "
                "UNAUTHENTICATED and its payload is a pickle — every peer "
                "that can connect gains code execution; use a loopback or "
                "unix socket unless the network is fully trusted",
                address=address,
            )
        self._family = family
        if family == "tcp":
            self._srv = socket.create_server(target)
        else:
            self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._srv.bind(target)
            self._srv.listen()
        self._path = target if family == "unix" else None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: set[socket.socket] = set()
        self._conns_lock = threading.Lock()
        # resolved at bind time (port 0 → ephemeral) and kept past stop()
        if family == "tcp":
            host, port = self._srv.getsockname()[:2]
            self.address = f"{host}:{port}"
        else:
            self.address = str(self._path)
        # the pool identity this daemon answers as: every reply carries it,
        # so client-side failover spans and /debug/solverd name the replica
        # that actually served each solve
        self.replica_id = replica_id or self.address

    def start(self) -> "SolverDaemon":
        self._thread = threading.Thread(
            target=self._accept_loop, name="solverd-accept", daemon=True
        )
        self._thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            self._serve_frames(conn)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _serve_frames(self, conn: socket.socket) -> None:
        with conn:
            while not self._stop.is_set():
                try:
                    msg = recv_frame(conn)
                except (TransportError, OSError):
                    return
                if msg is None:
                    return
                try:
                    reply = self._process(msg)
                except Exception as e:  # noqa: BLE001 — keep the conn alive
                    reply = _error_reply(e)
                    # failed solves re-join the caller's trace too: the
                    # error-status daemon spans are exactly what a user
                    # debugging the failure drills into
                    self._attach_spans(reply, msg.get("trace"))
                reply.setdefault("replica", self.replica_id)
                try:
                    send_frame(conn, reply)
                except OSError:
                    return

    @staticmethod
    def _attach_spans(reply: dict, trace) -> None:
        """Span backhaul: hand the caller's trace its daemon-side spans
        (taken, not copied — each span ships home exactly once)."""
        if isinstance(trace, dict) and trace.get("trace_id"):
            from karpenter_tpu_torch import tracing

            reply["spans"] = tracing.tracer().ring.take_trace(trace["trace_id"])

    def _process(self, msg: dict) -> dict:
        if msg.get("op") == "stats":
            return {"ok": True, "stats": self.service.stats()}
        if msg.get("op") == "solve_many":
            return self._process_many(msg)
        if msg.get("op") != "solve":
            return _error_reply(TransportError(f"unknown op {msg.get('op')}"))
        trace = msg.get("trace")
        request = self._decode_request(msg, msg["payload"])
        results = self.service.solve(request)
        reply = {"ok": True, "payload": _pack(_detached(results))}
        self._attach_spans(reply, trace)
        return reply

    def _decode_request(
        self, msg: dict, payload: str, request_id: Optional[str] = None
    ) -> SolveRequest:
        body = _unpack(payload)
        scheduler = body["scheduler"]
        catalog = body.get("catalog")
        if catalog:
            # port: a failed engine build is the request's error (its type
            # rides the error reply) — a daemon that owns the card never
            # answers from the host loop instead
            scheduler.engine = self.engine_factory(catalog)
        deadline_rel = msg.get("deadline_rel")
        return SolveRequest(
            kind=msg.get("kind", api.KIND_SOLVE),
            scheduler=scheduler,
            pods=body["pods"],
            timeout=msg.get("timeout"),
            deadline=None
            if deadline_rel is None
            else self.service.clock.now() + deadline_rel,
            client="socket",
            trace_context=msg.get("trace"),
            group=msg.get("group"),
            group_nested=bool(msg.get("nested", False)),
            request_id=(
                request_id
                if request_id is not None
                else msg.get("request_id", "") or ""
            ),
            tenant=msg.get("tenant", "") or "",
        )

    def _process_many(self, msg: dict) -> dict:
        """One frame, one admission group, one coalesced batch: the frontier
        client's k probes decode into k SolveRequests sharing the frame's
        control plane (kind/timeout/deadline/group/trace) and execute via
        service.solve_many, so a socket-side frontier round batches exactly
        like an in-process one. Verdicts travel back per item — a failed
        probe reports its typed error without voiding its siblings."""
        trace = msg.get("trace")
        payloads = msg.get("payloads", [])
        ids = msg.get("request_ids") or [""] * len(payloads)
        requests = [
            self._decode_request(msg, payload, request_id=rid)
            for payload, rid in zip(payloads, ids)
        ]
        entries = self.service.solve_many(requests)
        results = []
        for entry in entries:
            if entry.error is not None:
                results.append(_error_reply(entry.error))
            else:
                results.append(
                    {"ok": True, "payload": _pack(_detached(entry.result))}
                )
        reply = {"ok": True, "results": results}
        self._attach_spans(reply, trace)
        return reply

    def drain_and_stop(self, grace: float = 10.0, poll: float = 0.05) -> bool:
        """Graceful SIGTERM exit: flip the service into draining mode (new
        requests get a typed DrainingError reply — shed, never block; a
        pool client fails over on it), let in-flight and already-admitted
        batches finish, then tear the listener down. Returns True when the
        service quiesced inside the grace window, False when the grace
        expired and still-running work was abandoned to stop()."""
        self.service.drain()
        deadline = time.monotonic() + max(0.0, grace)
        quiesced = self.service.quiesced()
        while not quiesced and time.monotonic() < deadline:
            time.sleep(poll)
            quiesced = self.service.quiesced()
        self.stop()
        self.service.close()
        return quiesced

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        # Tear down live handler connections too: otherwise their threads
        # stay parked in recv until every client goes away, and the port
        # can't be rebound for a restart.
        with self._conns_lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._path:
            import os

            try:
                os.unlink(self._path)
            except OSError:
                pass


def _error_reply(e: Exception) -> dict:
    return {
        "ok": False,
        "error": {"type": type(e).__name__, "message": str(e)},
    }


def _detached(results):
    """Detach the daemon's engine from a result graph before pickling — the
    claim objects reference it and device arrays don't travel."""
    for nc in results.new_node_claims:
        nc.engine = None
    return results


def _default_engine_factory(shard_devices: int = 0, device=None):
    """Content-cached CatalogEngine builder for the daemon: one engine per
    distinct catalog (by instance-type fingerprint), encoded once. With
    `shard_devices` >= 1 (the daemon's --shard-devices flag) every rebuilt
    engine carries an N-device mesh, so sweeps shipped to this sidecar run
    shard_mapped over its local chips — the daemon owns the accelerator,
    so the mesh lives HERE, not in the operator that shipped the catalog.

    port: `device` is the engines' torch device — None is the card, and
    building an engine without one raises; "cpu" is for the tests."""
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        _build_solver_mesh,
        _type_fingerprint,
    )

    cache: dict[tuple, object] = {}

    def factory(catalog: list):
        from karpenter_tpu_torch.ops.catalog import CatalogEngine

        key = tuple(_type_fingerprint(it) for it in catalog)
        engine = cache.get(key)
        if engine is None:
            # engine (re)build: the device-memory gauges sampled against a
            # previous engine's allocations are stale now — clear the family
            # so /metrics never serves evicted-engine values, and resample
            # once the build lands (the per-batch sampler keeps it fresh)
            from karpenter_tpu_torch.observability import kernels as kobs

            kobs.reset_device_memory()
            # the catalog changed: any solver residency (ops/delta.py) was
            # stamped against the previous engine's row generation and must
            # not seed a warm resume against the rebuilt one
            from karpenter_tpu_torch.ops import delta as delta_mod

            delta_mod.invalidate_all("engine-rebuild")
            engine = CatalogEngine(
                catalog, device=device, mesh=_build_solver_mesh(shard_devices)
            )
            # warm-start path for daemon restarts: with the AOT compile
            # service configured (--compile-cache-dir / --aot-ladder), a
            # rebuilt engine loads its ladder executables from the
            # persistent cache instead of lazily jit-compiling inside the
            # first solve after the restart
            from karpenter_tpu_torch.aot import runtime as aotrt

            if aotrt.enabled():
                from karpenter_tpu_torch import aot

                try:
                    aot.warm_start(engine)
                except KernelError:
                    # port: a kernel that fails to build or to launch is the
                    # request's error, never hidden behind the lazy path
                    raise
                except Exception as e:  # noqa: BLE001 — never fail a solve
                    from karpenter_tpu_torch.operator import logging as klog

                    klog.logger("solverd").warning(
                        "AOT warm start failed for rebuilt engine; "
                        "falling back to lazy JIT",
                        error=f"{type(e).__name__}: {e}",
                    )
            # resample against the NEW engine's allocations so the gauges
            # carry real values between the rebuild and the first batch
            try:
                kobs.sample_device_memory()
            except Exception:  # noqa: BLE001 — telemetry must not fail a rebuild
                pass
            cache[key] = engine
        return engine

    return factory
