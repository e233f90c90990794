"""Persistent on-disk executable cache: content-keyed, corruption-safe,
concurrent-writer-safe.

Entries are opaque byte blobs (the compiler stores pickled serialized XLA
executables) under sha256 keys; the key embeds everything that makes an
executable valid (catalog content hash, jax/XLA version, device kind,
kernel, bucket signature, ladder version — see aot/compiler.cache_key), so
a mismatch is a MISS, never a wrong load.

Failure discipline — the cache must never be the thing that crashes a
daemon boot:

- corrupted/truncated entry: detected by magic + whole-body sha256
  checksum; the entry is evicted (best-effort unlink), a warning logged,
  and the caller falls back to a fresh JIT compile
- concurrent writers (two daemons sharing a cache dir): writes go to a
  per-writer temp file then `os.replace` — readers only ever see complete
  entries; losing a write race is harmless (both wrote identical bytes)
- read-only/unwritable cache dir: writes degrade to a warning + counter;
  reads (and the daemon) keep working
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Optional

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator import logging as klog

_log = klog.logger("aot.cache")

MAGIC = b"KTAOT1\n"
_SUFFIX = ".aotx"

# process-cumulative totals across every cache instance: runtime.stats()
# reads these so deltas stay monotonic even when a re-configure swaps the
# active cache object (per-instance counters live on each cache for
# /debug introspection)
_TOTALS = {"hits": 0, "misses": 0, "evictions": 0, "write_errors": 0}
_totals_lock = threading.Lock()


def totals() -> dict:
    with _totals_lock:
        return dict(_TOTALS)

_HITS = global_registry.counter(
    "karpenter_aot_cache_hits_total",
    "AOT executable cache entries loaded from disk",
)
_MISSES = global_registry.counter(
    "karpenter_aot_cache_misses_total",
    "AOT executable cache lookups that found no entry",
)
_EVICTIONS = global_registry.counter(
    "karpenter_aot_cache_evictions_total",
    "corrupt/unreadable AOT cache entries evicted",
)


class ExecutableCache:
    """One cache directory of checksummed entry files."""

    def __init__(self, root: str):
        self.root = root
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.write_errors = 0
        try:
            os.makedirs(root, exist_ok=True)
        except OSError as e:
            # an uncreatable dir behaves like an empty read-only cache
            _log.warning(
                "AOT cache dir not creatable; cache degraded to misses",
                root=root, error=str(e),
            )

    def _path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}{_SUFFIX}")

    # -- reads ---------------------------------------------------------------

    def get(self, key: str) -> Optional[bytes]:
        """The entry's body bytes, or None (miss / evicted-corrupt).

        Does NOT count a hit: "hit" means an executable actually SERVED
        from the cache, which the caller only knows after deserialization
        succeeds — it confirms with ``count_hit()`` (or converts the read
        into an eviction with ``evict()``), so the hits counter the README
        runbook diagnoses from never overstates warm starts."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            self._count("misses")
            _MISSES.inc()
            return None
        except OSError as e:
            _log.warning("AOT cache read failed", key=key, error=str(e))
            self._count("misses")
            _MISSES.inc()
            return None
        body = self._verify(raw)
        if body is None:
            self._evict(key, path, "corrupt or truncated entry")
            return None
        return body

    def count_hit(self) -> None:
        """Confirm a get() whose payload deserialized and loaded."""
        self._count("hits")
        _HITS.inc()

    def evict(self, key: str, reason: str) -> None:
        """Drop an entry whose bytes read clean but whose payload failed to
        load (deserialize error, toolchain drift inside a valid envelope)."""
        self._evict(key, self._path(key), reason)

    @staticmethod
    def _verify(raw: bytes) -> Optional[bytes]:
        if not raw.startswith(MAGIC):
            return None
        head = len(MAGIC)
        digest, body = raw[head : head + 64], raw[head + 65 :]
        if raw[head + 64 : head + 65] != b"\n":
            return None
        if hashlib.sha256(body).hexdigest().encode("ascii") != digest:
            return None
        return body

    def _evict(self, key: str, path: str, reason: str) -> None:
        self._count("evictions")
        _EVICTIONS.inc()
        _log.warning(
            "evicting bad AOT cache entry; falling back to JIT",
            key=key, reason=reason,
        )
        try:
            os.unlink(path)
        except OSError:
            pass  # another writer may have already replaced/removed it

    # -- writes --------------------------------------------------------------

    def put(self, key: str, body: bytes) -> bool:
        """Atomically write an entry; False (plus a warning + counter) when
        the directory is unwritable — the caller's executable still works,
        only the NEXT boot loses the warm start."""
        path = self._path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        blob = (
            MAGIC
            + hashlib.sha256(body).hexdigest().encode("ascii")
            + b"\n"
            + body
        )
        try:
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
            return True
        except OSError as e:
            self._count("write_errors")
            _log.warning(
                "AOT cache write failed; next boot will re-compile",
                key=key, error=str(e),
            )
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False

    # -- stats ---------------------------------------------------------------

    def _count(self, name: str) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + 1)
        with _totals_lock:
            _TOTALS[name] += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "root": self.root,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "write_errors": self.write_errors,
            }
