"""Write-ahead intent journal: crash consistency for external mutations.

The reference Karpenter leans on the API server for durability — a crashed
controller restarts, lists the world, and reconciles. Our operator keeps
in-flight intent in process memory, so a crash between "solver decided" and
"cloud create acknowledged" could double-launch or leak capacity. This module
closes that hole with the classic write-ahead discipline: every externally
visible mutation (NodeClaim launch, cloud delete, disruption command, pod
bind) appends a durable ``intent`` record BEFORE the side effect and a
``done``/``failed`` record after. On boot ``Operator.recover()`` replays
pending intents against observed cluster/cloud state and adopts, orphans, or
rolls back (operator/operator.py:recover).

File format (mirrors the AOT cache's corruption discipline, aot/cache.py):
a magic header then checksummed length-prefixed frames::

    KTWAL1\\n
    [4-byte big-endian payload length][32-byte sha256(payload)][payload JSON]

Appends are fsync'd. On open, the file is scanned frame by frame; a torn
tail or a checksum mismatch truncates the file at the last good frame and
warns — recovery proceeds from what provably hit the disk. An unwritable
``--journal-dir`` degrades to an in-memory journal with a single warning
(boot never fails on journal trouble; it only loses crash durability).
Compaction rewrites live records through a per-writer tmp file + ``os.replace``
so concurrent writers or a crash mid-rotate never corrupt the log.

Crash barriers: the sim's crash injector arms a one-shot hook at one of
three named points in every journaled mutation —

- ``pre-intent``: before the intent record is written (proves no side
  effect precedes the intent),
- ``post-intent-pre-effect``: intent durable, side effect not yet issued
  (recovery must probe-and-resolve),
- ``post-effect-pre-done``: side effect acknowledged, completion record
  lost (recovery must adopt by idempotency key).

The crash signal derives from BaseException so the reconciler harness's
per-controller ``except Exception`` isolation cannot swallow it — a crash
kills the whole pass, exactly like SIGKILL would.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import threading
from typing import Callable, Optional

from karpenter_tpu_torch.metrics.registry import global_registry
from karpenter_tpu_torch.operator import logging as klog

_log = klog.logger("runtime.journal")

MAGIC = b"KTWAL1\n"
_HEADER = struct.Struct(">I")
_DIGEST_LEN = 32
_MAX_RECORD = 4 * 1024 * 1024  # a record is a small JSON dict; cap corrupt lengths

JOURNAL_FILE = "journal.log"

# Claims carry their launch idempotency key as an annotation so the cloud
# provider (kwok) can make create() key-idempotent: a retried or replayed
# create with the same key returns the existing instance instead of
# materializing a second node.
IDEMPOTENCY_ANNOTATION = "karpenter.sh/launch-idempotency-key"

# Named crash barriers (see module docstring).
BARRIER_PRE_INTENT = "pre-intent"
BARRIER_POST_INTENT = "post-intent-pre-effect"
BARRIER_POST_EFFECT = "post-effect-pre-done"
BARRIERS = (BARRIER_PRE_INTENT, BARRIER_POST_INTENT, BARRIER_POST_EFFECT)

# how many resolved records may accumulate before an append triggers
# compaction (rewrite live intents only, tmp + os.replace)
COMPACT_THRESHOLD = 512

_APPENDS = global_registry.counter(
    "karpenter_journal_appends_total",
    "Journal records appended, by record type",
    labels=["type"],
)
_REPLAYS = global_registry.counter(
    "karpenter_journal_replays_total",
    "Pending intents replayed during recovery",
)
_ADOPTIONS = global_registry.counter(
    "karpenter_journal_adoptions_total",
    "Acknowledged-but-unrecorded creates adopted by idempotency key",
)
_ORPHANS = global_registry.counter(
    "karpenter_journal_orphans_total",
    "Acknowledged creates with no surviving claim, marked for gc to reap",
)
_ROLLBACKS = global_registry.counter(
    "karpenter_journal_rollbacks_total",
    "In-flight disruption commands rolled back during recovery",
)
_TRUNCATIONS = global_registry.counter(
    "karpenter_journal_truncations_total",
    "Torn or corrupt journal tails truncated on open",
)


class OperatorCrash(BaseException):
    """Simulated operator death at a journal barrier.

    BaseException on purpose: the reconciler harness isolates controller
    failures with ``except Exception`` (operator/harness.py) — a crash must
    tear down the whole pass, not be absorbed as one reconcile error.
    """

    def __init__(self, barrier: str, action: str = ""):
        super().__init__(f"operator crash at {barrier} ({action or 'any'})")
        self.barrier = barrier
        self.action = action


def _encode(record: dict) -> bytes:
    payload = json.dumps(record, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return _HEADER.pack(len(payload)) + hashlib.sha256(payload).digest() + payload


class Journal:
    """Append-only intent journal with named crash barriers.

    ``intent()`` returns a sequence number; the caller performs the side
    effect then closes the intent with ``done(seq)`` or ``failed(seq)``.
    Intents with neither are "pending" — the recovery work list.
    """

    def __init__(self, journal_dir: str = "", clock=None):
        self.journal_dir = journal_dir or ""
        self.clock = clock
        self.path = os.path.join(self.journal_dir, JOURNAL_FILE) if self.journal_dir else ""
        self._lock = threading.RLock()
        self._records: list[dict] = []
        self._pending: dict[int, dict] = {}
        self._seq = 0
        self._fh = None
        self._appends = 0
        self._truncated_frames = 0
        self._write_errors = 0
        self._write_warned = False
        self._resolved_since_compact = 0
        self._compactions = 0
        self._armed: Optional[tuple[str, Optional[str]]] = None
        self._barrier_hook: Optional[Callable[[str, dict], None]] = None
        self._recovered = True
        self._pass_id = 0
        if self.path:
            self._open()
        # only a journal that came up with unresolved on-disk intents is
        # "recovering" — a fresh boot is immediately healthy
        self._recovered = not self._pending

    # ------------------------------------------------------------------ file

    def _open(self) -> None:
        """Load existing records, truncating any torn/corrupt tail, then
        position an append handle. Unwritable dir => in-memory degrade."""
        try:
            os.makedirs(self.journal_dir, exist_ok=True)
            if os.path.exists(self.path):
                self._load()
            else:
                with open(self.path, "wb") as f:
                    f.write(MAGIC)
                    f.flush()
                    os.fsync(f.fileno())
            self._fh = open(self.path, "ab")
        except OSError as e:
            self._fh = None
            self._warn_once("journal dir unwritable; degrading to in-memory", error=str(e))

    def _load(self) -> None:
        with open(self.path, "rb") as f:
            blob = f.read()
        if not blob.startswith(MAGIC):
            # unrecognized file: evict wholesale, like a corrupt AOT entry
            _log.warning("journal header corrupt; starting fresh", path=self.path)
            _TRUNCATIONS.inc()
            self._truncated_frames += 1
            with open(self.path, "wb") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
            return
        offset = len(MAGIC)
        valid_end = offset
        while offset < len(blob):
            frame_start = offset
            if offset + _HEADER.size + _DIGEST_LEN > len(blob):
                break  # torn tail: header or digest cut short
            (length,) = _HEADER.unpack_from(blob, offset)
            offset += _HEADER.size
            digest = blob[offset : offset + _DIGEST_LEN]
            offset += _DIGEST_LEN
            if length > _MAX_RECORD or offset + length > len(blob):
                offset = frame_start
                break  # corrupt length or torn payload
            payload = blob[offset : offset + length]
            offset += length
            if hashlib.sha256(payload).digest() != digest:
                offset = frame_start
                break  # checksum mismatch: stop replay at last good frame
            try:
                record = json.loads(payload)
            except (ValueError, UnicodeDecodeError):
                offset = frame_start
                break
            self._index(record)
            valid_end = offset
        if offset < len(blob) or valid_end < len(blob):
            dropped = len(blob) - valid_end
            _log.warning(
                "journal tail torn or corrupt; truncating",
                path=self.path,
                dropped_bytes=dropped,
                records_kept=len(self._records),
            )
            _TRUNCATIONS.inc()
            self._truncated_frames += 1
            with open(self.path, "r+b") as f:
                f.truncate(valid_end)
                f.flush()
                os.fsync(f.fileno())

    def _index(self, record: dict) -> None:
        self._records.append(record)
        rtype = record.get("type")
        seq = record.get("seq", 0)
        if rtype == "intent":
            self._pending[seq] = record
            self._seq = max(self._seq, seq)
        elif rtype in ("done", "failed"):
            self._pending.pop(record.get("of", -1), None)
            self._resolved_since_compact += 1

    def _append(self, record: dict) -> None:
        self._records.append(record)
        self._appends += 1
        _APPENDS.inc({"type": record["type"]})
        if self._fh is None:
            return
        try:
            self._fh.write(_encode(record))
            self._fh.flush()
            os.fsync(self._fh.fileno())
        except OSError as e:
            self._write_errors += 1
            self._warn_once("journal append failed; degrading to in-memory", error=str(e))
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    def _warn_once(self, msg: str, **fields) -> None:
        if not self._write_warned:
            self._write_warned = True
            _log.warning(msg, path=self.path or "<memory>", **fields)

    # -------------------------------------------------------------- barriers

    def set_barrier_hook(self, fn: Optional[Callable[[str, dict], None]]) -> None:
        """Install a hook called at every named barrier with (barrier,
        record). The sim's crash injector raises OperatorCrash from it."""
        self._barrier_hook = fn

    def arm_crash(self, barrier: str, action: Optional[str] = None) -> None:
        """One-shot: raise OperatorCrash at the next matching barrier.
        ``action=None`` matches any journaled action."""
        if barrier not in BARRIERS:
            raise ValueError(f"unknown journal barrier {barrier!r} (known: {', '.join(BARRIERS)})")
        self._armed = (barrier, action)

    def _barrier(self, name: str, record: dict) -> None:
        if self._armed is not None:
            barrier, action = self._armed
            if name == barrier and (action is None or record.get("action") == action):
                self._armed = None
                raise OperatorCrash(name, record.get("action", ""))
        if self._barrier_hook is not None:
            self._barrier_hook(name, record)

    # ----------------------------------------------------------------- write

    def _now(self) -> float:
        return round(self.clock.now(), 6) if self.clock is not None else 0.0

    def set_pass(self, pass_id: int) -> None:
        self._pass_id = pass_id

    def intent(self, action: str, uid: str = "", key: str = "", **fields) -> int:
        """Record intent to mutate. Fires ``pre-intent`` before the durable
        append and ``post-intent-pre-effect`` after; returns the sequence
        number the caller closes with done()/failed()."""
        with self._lock:
            self._seq += 1
            record = {
                "type": "intent",
                "seq": self._seq,
                "action": action,
                "uid": uid,
                "key": key,
                "pass": self._pass_id,
                "ts": self._now(),
            }
            record.update(fields)
            self._barrier(BARRIER_PRE_INTENT, record)
            self._append(record)
            self._pending[record["seq"]] = record
            self._barrier(BARRIER_POST_INTENT, record)
            return record["seq"]

    def done(self, seq: int, barrier: bool = True, **fields) -> None:
        """Close an intent: the side effect is acknowledged. Fires
        ``post-effect-pre-done`` (unless ``barrier=False`` — recovery's own
        resolutions must not re-trigger an armed crash)."""
        with self._lock:
            intent = self._pending.get(seq, {})
            record = {
                "type": "done",
                "of": seq,
                "action": intent.get("action", ""),
                "ts": self._now(),
            }
            record.update(fields)
            if barrier:
                self._barrier(BARRIER_POST_EFFECT, record)
            self._append(record)
            self._pending.pop(seq, None)
            self._resolved_since_compact += 1
            self._maybe_compact()

    def failed(self, seq: int, error: str = "", **fields) -> None:
        """Close an intent whose side effect did not (or must not) complete.
        No barrier: the effect never happened, so there is no
        post-effect window to crash in."""
        with self._lock:
            intent = self._pending.get(seq, {})
            record = {
                "type": "failed",
                "of": seq,
                "action": intent.get("action", ""),
                "error": error[:300],
                "ts": self._now(),
            }
            record.update(fields)
            self._append(record)
            self._pending.pop(seq, None)
            self._resolved_since_compact += 1
            self._maybe_compact()

    # ------------------------------------------------------------ compaction

    def _maybe_compact(self) -> None:
        if self._resolved_since_compact >= COMPACT_THRESHOLD:
            self.compact()

    def compact(self) -> None:
        """Rewrite the journal keeping only pending intents, via a
        per-writer tmp file + os.replace (the AOT cache's crash-safe write
        discipline) — a crash mid-compaction leaves the old log intact."""
        with self._lock:
            live = [self._pending[seq] for seq in sorted(self._pending)]
            self._records = list(live)
            self._resolved_since_compact = 0
            self._compactions += 1
            if not self.path:
                return
            tmp = f"{self.path}.tmp.{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    f.write(MAGIC)
                    for record in live:
                        f.write(_encode(record))
                    f.flush()
                    os.fsync(f.fileno())
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                os.replace(tmp, self.path)
                self._fh = open(self.path, "ab")
            except OSError as e:
                self._write_errors += 1
                self._warn_once("journal compaction failed", error=str(e))
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    # -------------------------------------------------------------- recovery

    def pending(self) -> list[dict]:
        """Intents with no done/failed record, in append order — the
        recovery work list. Same journal bytes => same list (replay
        determinism)."""
        with self._lock:
            return [dict(self._pending[seq]) for seq in sorted(self._pending)]

    def recovering(self) -> bool:
        """True while on-disk intents from a previous incarnation await
        Operator.recover() — surfaces as a /healthz degraded reason."""
        return not self._recovered

    def mark_recovered(self) -> None:
        self._recovered = True

    def note_replay(self) -> None:
        _REPLAYS.inc()

    def note_adoption(self) -> None:
        _ADOPTIONS.inc()

    def note_orphan(self) -> None:
        _ORPHANS.inc()

    def note_rollback(self) -> None:
        _ROLLBACKS.inc()

    # ------------------------------------------------------------ inspection

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def frame(self) -> dict:
        """Deterministic facts only — this feeds the flight recorder ring,
        which rides under the sim digest."""
        with self._lock:
            return {
                "depth": len(self._pending),
                "appends": self._appends,
                "truncated_frames": self._truncated_frames,
                "write_errors": self._write_errors,
                "compactions": self._compactions,
                "mode": "file" if self._fh is not None else "memory",
                "recovering": not self._recovered,
            }

    def snapshot(self) -> dict:
        """Full /debug/journal view (not digest-covered; paths allowed)."""
        with self._lock:
            snap = self.frame()
            snap["path"] = self.path or None
            snap["records"] = len(self._records)
            snap["pending"] = [
                {
                    "seq": r.get("seq"),
                    "action": r.get("action"),
                    "uid": r.get("uid"),
                    "key": r.get("key"),
                    "pass": r.get("pass"),
                    "ts": r.get("ts"),
                }
                for r in self.pending()
            ]
            return snap

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
