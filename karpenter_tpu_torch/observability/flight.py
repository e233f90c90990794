"""Always-on flight recorder: a bounded ring of per-pass system snapshots,
dumped as a self-contained postmortem bundle at the moment of breach.

Aviation's blackbox, applied to the serving path: every operator pass
records one *frame* — a snapshot of every registered source (harness
health ledger, admission-queue depth and tenant quota state, breaker
states, kernel-registry deltas, active span summaries, fleet replica
view, SLO burn state) — into a ring that holds the last N passes. The
recorder costs one dict-walk per pass and is always on; when something
breaches (an ``SLOBreach``, an operator crash, a SIGQUIT) the ring is
**dumped**: the frames become a JSONL bundle under ``--flight-dir`` whose
header line carries a sha256 digest over the frame lines, so the evidence
of "what the system looked like for the last N passes" survives the
incident and is tamper-evident.

Determinism contract (the same split PR 4 applies to span export): frames
may carry wall-clock measurements for the live debug surface, but the
*dump* scrubs every volatile key (``VOLATILE_KEYS``) before digesting and
writing — so two same-seed sim runs produce byte-identical breach bundles,
and the bundle digest is a regression fingerprint exactly like the event
log's. Sources are registered with keyed-replace semantics (a rebuilt
Operator swaps its slot); each source is a zero-argument callable
returning a JSON-serializable dict and must never raise into the pass —
a failing source is recorded as its error string instead.

Surfaces: ``/debug/flight`` (ring summary + bundle listing, ``?bundle=``
drill-down, 404 on unknown ids) and the sim's ``report["flight"]``
section (frame/bundle digests, digest-stable across same-seed runs).
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
from collections import deque
from typing import Callable, Optional

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.utils.clock import Clock

_FRAMES = global_registry.counter(
    "karpenter_flight_frames_total",
    "flight-recorder frames captured, by trigger",
    labels=["trigger"],
)
_DUMPS = global_registry.counter(
    "karpenter_flight_dumps_total",
    "postmortem bundles dumped, by trigger",
    labels=["trigger"],
)
_RING_DEPTH = global_registry.gauge(
    "karpenter_flight_ring_depth",
    "frames currently held in the flight-recorder ring",
)
_BUNDLE_BYTES = global_registry.histogram(
    "karpenter_flight_bundle_bytes",
    "serialized size of dumped postmortem bundles",
    buckets=(1024, 4096, 16384, 65536, 262144, 1048576, 4194304),
)

# Keys scrubbed (recursively) from frames before a dump is digested or
# written: wall-clock measurements and process-history counters that
# legitimately differ between two replays of the same scenario — the exact
# volatile-attr discipline the deterministic tracer applies at span export.
VOLATILE_KEYS = frozenset(
    {
        "last_batch_seconds",
        "compile_wall_s",
        "execute_wall_s",
        "mean_execute_s",
        "max_execute_s",
        "joint_sweeps",
        "device_solves",
        "device_fallbacks",
        "device_memory",
        "live_array_bytes",
        "live_arrays",
        "reconnects",
        "aot",
    }
)

# bundles whose frame payloads stay resident for /debug/flight drill-down
_BUNDLE_KEEP = 8
# default minimum virtual seconds between dumps sharing a trigger key: a
# burning objective must not shed one bundle per pass
DUMP_COOLDOWN = 60.0


def scrub(obj):
    """Recursively drop VOLATILE_KEYS from a JSON-shaped value."""
    if isinstance(obj, dict):
        return {
            k: scrub(v) for k, v in obj.items() if k not in VOLATILE_KEYS
        }
    if isinstance(obj, (list, tuple)):
        return [scrub(v) for v in obj]
    return obj


def canonical(frame: dict) -> str:
    return json.dumps(frame, sort_keys=True, separators=(",", ":"))


def _slug(text: str) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "-", text).strip("-").lower() or "dump"


class FlightRecorder:
    """Process-global blackbox (module accessor: ``recorder()``)."""

    def __init__(
        self,
        clock: Optional[Clock] = None,
        capacity: int = 64,
        flight_dir: str = "",
    ):
        self._lock = threading.Lock()
        self.clock = clock or Clock()
        self.capacity = capacity
        self.flight_dir = flight_dir
        self._sources: dict[str, Callable[[], dict]] = {}
        self._ring: deque = deque(maxlen=max(1, capacity))
        self._seq = 0  # frames ever recorded
        self._bundle_seq = 0
        self._bundles: deque = deque(maxlen=_BUNDLE_KEEP)
        self._last_dump: dict[str, float] = {}

    # -- configuration -------------------------------------------------------

    def configure(
        self,
        clock: Optional[Clock] = None,
        capacity: Optional[int] = None,
        flight_dir: Optional[str] = None,
    ) -> "FlightRecorder":
        """Re-point the recorder (a new Operator, a sim run). Registered
        sources persist — they replace themselves by key."""
        with self._lock:
            if clock is not None:
                self.clock = clock
            if capacity is not None and capacity != self.capacity:
                self.capacity = capacity
                self._ring = deque(self._ring, maxlen=max(1, capacity))
            if flight_dir is not None:
                self.flight_dir = flight_dir
        return self

    def reset(self) -> None:
        """Drop frames, bundles, and sequence state (sim run start);
        sources, clock, and configuration survive."""
        with self._lock:
            self._ring.clear()
            self._seq = 0
            self._bundle_seq = 0
            self._bundles.clear()
            self._last_dump.clear()
        _RING_DEPTH.set(0.0)

    def register_source(self, name: str, fn: Callable[[], dict]) -> None:
        """Register (or replace) a named snapshot source. The name is the
        key in every frame's ``sources`` dict AND the replace key."""
        with self._lock:
            self._sources[name] = fn

    def unregister_source(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    # -- recording -----------------------------------------------------------

    def record(self, trigger: str, now: Optional[float] = None) -> dict:
        """Capture one frame: snapshot every source. A source that raises
        contributes ``{"error": ...}`` instead of aborting the frame —
        recording must never take down the pass it is documenting."""
        with self._lock:
            t = self.clock.now() if now is None else now
            self._seq += 1
            frame = {"seq": self._seq, "t": round(t, 6), "trigger": trigger}
            sources = dict(self._sources)
        captured = {}
        for name in sorted(sources):
            try:
                captured[name] = sources[name]()
            except Exception as e:  # noqa: BLE001 — the blackbox must not crash the plane
                captured[name] = {"error": f"{type(e).__name__}: {e}"}
        frame["sources"] = captured
        with self._lock:
            self._ring.append(frame)
            depth = len(self._ring)
        _FRAMES.inc({"trigger": trigger})
        _RING_DEPTH.set(float(depth))
        return frame

    # -- dumping -------------------------------------------------------------

    def dump(
        self,
        trigger: str,
        now: Optional[float] = None,
        cooldown: float = DUMP_COOLDOWN,
        context: Optional[dict] = None,
        lock_timeout: Optional[float] = None,
    ) -> Optional[dict]:
        """Dump the ring as a postmortem bundle. Returns the bundle record,
        or None when the trigger is inside its cooldown window (a burning
        objective asks once per breach edge, not once per pass). The bundle
        is always kept in memory for /debug/flight; it is also written to
        ``flight_dir`` when one is configured. Frames are scrubbed of
        volatile keys before digesting/writing, so same-seed sim runs dump
        byte-identical bundles.

        ``lock_timeout`` makes the dump non-deadlocking for callers that
        may interrupt a lock holder — Python delivers signal handlers on
        the main thread, so a SIGQUIT arriving while the operator loop is
        inside ``record()`` would otherwise block forever on a lock its
        own (suspended) thread holds. With a timeout, the acquire gives up
        and the dump returns None instead."""
        if not self._lock.acquire(
            timeout=-1 if lock_timeout is None else lock_timeout
        ):
            return None
        try:
            t = self.clock.now() if now is None else now
            last = self._last_dump.get(trigger)
            if last is not None and cooldown > 0 and t - last < cooldown:
                return None
            self._last_dump[trigger] = t
            self._bundle_seq += 1
            name = f"flight-{self._bundle_seq:04d}-{_slug(trigger)}"
            frames = [scrub(frame) for frame in self._ring]
        finally:
            self._lock.release()
        digest = hashlib.sha256()
        lines = []
        for frame in frames:
            line = canonical(frame)
            lines.append(line)
            digest.update(line.encode())
            digest.update(b"\n")
        sha = "sha256:" + digest.hexdigest()
        header = {
            "bundle": name,
            "trigger": trigger,
            "t": round(t, 6),
            "frames": len(frames),
            "sha256": sha,
        }
        if context:
            header["context"] = scrub(context)
        body = canonical(header) + "\n" + "\n".join(lines) + ("\n" if lines else "")
        bundle = {
            "name": name,
            "trigger": trigger,
            "t": round(t, 6),
            "frames": len(frames),
            "sha256": sha,
            "path": None,
        }
        if self.flight_dir:
            try:
                import os

                os.makedirs(self.flight_dir, exist_ok=True)
                path = os.path.join(self.flight_dir, name + ".jsonl")
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(body)
                os.replace(tmp, path)
                bundle["path"] = path
            except OSError as e:
                # a read-only or missing dir must not turn a breach into a
                # crash: the in-memory bundle still serves /debug/flight
                bundle["write_error"] = f"{type(e).__name__}: {e}"
        # serving threads only hold the lock for brief reads, so this
        # second acquire bounds out quickly even from a signal handler
        if self._lock.acquire(
            timeout=-1 if lock_timeout is None else lock_timeout
        ):
            try:
                self._bundles.append({**bundle, "_frames": frames})
            finally:
                self._lock.release()
        _DUMPS.inc({"trigger": trigger})
        _BUNDLE_BYTES.observe(float(len(body)))
        return bundle

    # -- queries -------------------------------------------------------------

    def snapshot(self, bundle: Optional[str] = None) -> Optional[dict]:
        """/debug/flight: ring summary + bundle listing, or one bundle's
        frames (None for an unknown bundle id → 404)."""
        with self._lock:
            if bundle is not None:
                for b in self._bundles:
                    if b["name"] == bundle:
                        out = {k: v for k, v in b.items() if k != "_frames"}
                        out["frame_records"] = list(b["_frames"])
                        return out
                return None
            ring = list(self._ring)
            return {
                "capacity": self.capacity,
                "frames_recorded": self._seq,
                "ring_depth": len(ring),
                "flight_dir": self.flight_dir or None,
                "sources": sorted(self._sources),
                "oldest_frame_t": ring[0]["t"] if ring else None,
                "newest_frame_t": ring[-1]["t"] if ring else None,
                "last_triggers": [f["trigger"] for f in ring[-5:]],
                "bundles": [
                    {k: v for k, v in b.items() if k != "_frames"}
                    for b in self._bundles
                ],
            }

    def report(self) -> dict:
        """The sim's ``report["flight"]`` section: deterministic facts only
        — frame count, a digest over the scrubbed ring, and the bundle
        listing (each bundle already carries its own digest)."""
        with self._lock:
            frames = [scrub(frame) for frame in self._ring]
            bundles = [
                {k: v for k, v in b.items() if k not in ("_frames", "path")}
                for b in self._bundles
            ]
            seq = self._seq
        digest = hashlib.sha256()
        for frame in frames:
            digest.update(canonical(frame).encode())
            digest.update(b"\n")
        return {
            "frames_recorded": seq,
            "ring_depth": len(frames),
            "ring_digest": "sha256:" + digest.hexdigest(),
            "bundles": bundles,
        }


_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def configure(
    clock: Optional[Clock] = None,
    capacity: Optional[int] = None,
    flight_dir: Optional[str] = None,
) -> FlightRecorder:
    return _RECORDER.configure(
        clock=clock, capacity=capacity, flight_dir=flight_dir
    )
