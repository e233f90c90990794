"""Simulator event log: an append-only, canonically-serialized record of
everything observable that happened during a run.

The log is the determinism contract: two runs of the same scenario with the
same seed must produce byte-identical logs, so the digest (sha256 over the
canonical JSON line of every entry) is a regression-diffable fingerprint of
end-to-end behavior. Anything nondeterministic (wall-clock timestamps, host
metrics, object ids outside the seeded uid source) must stay OUT of entries.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Iterator


def canonical(entry: dict) -> str:
    """One entry as its canonical JSON line (sorted keys, no whitespace
    variance, explicit separators)."""
    return json.dumps(entry, sort_keys=True, separators=(",", ":"))


class EventLog:
    def __init__(self) -> None:
        self._entries: list[dict] = []
        self._hash = hashlib.sha256()

    def append(self, t: float, ev: str, **fields: Any) -> dict:
        entry = {"t": round(t, 6), "ev": ev}
        entry.update(fields)
        self._entries.append(entry)
        self._hash.update(canonical(entry).encode())
        self._hash.update(b"\n")
        return entry

    def digest(self) -> str:
        return "sha256:" + self._hash.hexdigest()

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[dict]:
        return iter(self._entries)

    def entries(self, ev: str | None = None) -> list[dict]:
        if ev is None:
            return list(self._entries)
        return [e for e in self._entries if e["ev"] == ev]

    def to_jsonl(self) -> str:
        return "\n".join(canonical(e) for e in self._entries) + (
            "\n" if self._entries else ""
        )
