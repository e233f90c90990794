"""Span exporters: ring buffer, rolling digest, and JSONL file.

Every exporter consumes the same canonical span dict (``Span.to_dict``
applied by the tracer), so the digest, the JSONL file, and the debug
surface can never disagree about what a span contained. ``canonical``
mirrors ``sim/events.py``: sorted keys, explicit separators — the byte
layout IS the determinism contract.
"""

from __future__ import annotations

import hashlib
import json
import threading
from collections import OrderedDict, deque
from typing import Optional


def canonical(span: dict) -> str:
    return json.dumps(span, sort_keys=True, separators=(",", ":"))


class RingBufferExporter:
    """Last-N finished spans, evicted strictly oldest-first. Backs
    ``/debug/traces``: grouping the buffer by trace id reconstructs recent
    traces without unbounded memory."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._spans: deque = deque(maxlen=max(1, capacity))
        self._lock = threading.Lock()

    def export(self, span: dict) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def trace(self, trace_id: str) -> list[dict]:
        with self._lock:
            out = [d for d in self._spans if d.get("trace") == trace_id]
        out.sort(key=lambda d: (d.get("start", 0.0), d.get("end", 0.0)))
        return out

    def take_trace(self, trace_id: str) -> list[dict]:
        """Remove and return one trace's spans (the solverd daemon ships a
        request's spans back exactly once, in the reply frame)."""
        with self._lock:
            keep, taken = deque(maxlen=self._spans.maxlen), []
            for d in self._spans:
                (taken if d.get("trace") == trace_id else keep).append(d)
            self._spans = keep
        taken.sort(key=lambda d: (d.get("start", 0.0), d.get("end", 0.0)))
        return taken

    def summaries(self, limit: int = 20) -> list[dict]:
        """Most-recent traces (by last finished span), newest first: root
        name, span count, start/end bounds, error count."""
        if limit <= 0:
            return []
        with self._lock:
            snapshot = list(self._spans)
        traces: "OrderedDict[str, dict]" = OrderedDict()
        for d in snapshot:
            tid = d.get("trace")
            entry = traces.get(tid)
            if entry is None:
                entry = traces[tid] = {
                    "trace_id": tid,
                    "root": None,
                    "spans": 0,
                    "errors": 0,
                    "start": d.get("start"),
                    "end": d.get("end"),
                }
            else:
                # re-append so insertion order tracks recency of activity
                traces.move_to_end(tid)
            entry["spans"] += 1
            entry["start"] = min(entry["start"], d.get("start", entry["start"]))
            entry["end"] = max(entry["end"], d.get("end", entry["end"]))
            if d.get("status") == "error":
                entry["errors"] += 1
            if d.get("parent") is None:
                entry["root"] = d.get("name")
        out = list(traces.values())[-limit:]
        out.reverse()
        for entry in out:
            entry["duration"] = round(entry["end"] - entry["start"], 6)
        return out


class DigestExporter:
    """sha256 over the canonical line of every exported span — the span-log
    fingerprint the sim report embeds. O(1) memory; never stores spans."""

    def __init__(self):
        self._hash = hashlib.sha256()
        self.count = 0
        self._lock = threading.Lock()

    def export(self, span: dict) -> None:
        line = canonical(span).encode()
        with self._lock:
            self._hash.update(line)
            self._hash.update(b"\n")
            self.count += 1

    def digest(self) -> str:
        with self._lock:
            return "sha256:" + self._hash.hexdigest()


class JSONLExporter:
    """One canonical JSON line per span, appended as spans finish. Two
    same-seed deterministic runs write byte-identical files."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w", encoding="utf-8")
        self._lock = threading.Lock()

    def export(self, span: dict) -> None:
        line = canonical(span)
        with self._lock:
            if self._f is not None:
                self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
