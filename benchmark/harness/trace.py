"""Spans, records and the device trace of a traced run (`--trace 1`).

Spans come from the benchmark's own code: the loops open them around
their calls into the program, and the metric readers name program
functions to wrap (`SPANS`, with `record_<span>` and `CUDA_EVENTS`), which the traced run alone installs.
Each span is a `torch.profiler.record_function` too, so the device trace
can name what the host was doing in each idle gap. The untraced run
installs nothing and opens no profiler.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT = "unit"  # the span of one timed unit
GC_SPAN = "gc"  # a collection (gcclock.py): units pay for those between them too
# the traced window is the union of the units and the collections


def resolve(target: str):
    """`package.module:Attr.path` -> (the attribute's owner, its name)."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Tracer:
    def __init__(self, on: bool):
        self.on = on
        self.spans: dict = defaultdict(list)  # name -> [(t0, t1)] host perf_counter seconds
        self.records: dict = defaultdict(list)  # name -> [whatever the hook's recorder kept]
        self.events: dict = defaultdict(list)  # name -> [(start, end) torch.cuda.Event]
        self._undo: list = []
        self._prof = None
        self.active = False  # between start() and stop(): the window
        self.device = None  # DeviceTrace once the window closed
        self.notes: list = []  # lines for standard error, from the readers

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans[name].append((t0, time.perf_counter()))

    def wrap(self, name: str, target: str, recorder=None, cuda_events: bool = False) -> None:
        """Wrap a program function in the span `name`; `recorder(args,
        kwargs, result)` keeps what a reader needs from each call, and
        `cuda_events` fences the call with two CUDA events on the current
        stream (device time between them, read after the window)."""
        if not self.on:
            return
        import torch

        owner, attr = resolve(target)
        real = getattr(owner, attr)
        tracer = self

        def wrapper(*args, **kwargs):
            if not tracer.active:
                return real(*args, **kwargs)
            ev = None
            if cuda_events and torch.cuda.is_available():
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            with tracer.span(name):
                out = real(*args, **kwargs)
            if ev is not None:
                ev[1].record()
                tracer.events[name].append(ev)
            if recorder is not None:
                tracer.records[name].append(recorder(args, kwargs, out))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, real))

    def restore(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo.clear()

    def start(self) -> None:
        if not self.on:
            return
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.active = True

    def stop(self) -> None:
        if self._prof is None:
            return
        self.active = False
        self._prof.__exit__(None, None, None)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self._prof = None
        self.device = DeviceTrace(events, set(self.spans))

    def event_seconds(self, name: str) -> list:
        return [a.elapsed_time(b) / 1e3 for a, b in self.events.get(name, [])]


class DeviceTrace:
    """The device's activity within the timed units and the collections
    they pay for, from the profiler's chrome trace: kernels, copies and
    sets on the card, and the benchmark's spans on the host, on one
    timeline (microseconds)."""

    def __init__(self, events: list, span_names: set):
        self.ops = []  # (name, start, end) on the device
        self.host = []  # (name, start, end) of the benchmark's spans
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.ops.append((e.get("name", ""), ts, ts + dur))
            elif cat == "user_annotation" and e.get("name") in span_names:
                self.host.append((e["name"], ts, ts + dur))
        self.ops.sort(key=lambda o: o[1])
        self.windows = _union([(s, e) for n, s, e in self.host if n in (UNIT, GC_SPAN)])
        self.window_s = sum(e - s for s, e in self.windows) / 1e6
        self.busy = _clip(_union([(s, e) for _, s, e in self.ops]), self.windows)
        self.busy_s = sum(e - s for s, e in self.busy) / 1e6

    def op_seconds(self, match) -> float:
        """Device seconds of the ops whose name `match` accepts, inside the
        timed units."""
        spans = [(s, e) for n, s, e in self.ops if match(n)]
        return sum(e - s for s, e in _clip(spans, self.windows, merge=False)) / 1e6

    def top_ops(self, k: int = 10) -> list:
        total: dict = defaultdict(float)
        for n, s, e in self.ops:
            for a, b in _clip([(s, e)], self.windows, merge=False):
                total[n] += (b - a) / 1e6
        return [[n[:200], v] for n, v in sorted(total.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The longest device-idle gaps inside the timed units, each named by
        the innermost benchmark span open at its middle."""
        gaps = []
        starts = [b[0] for b in self.busy]
        for ws, we in self.windows:
            t = ws
            j = max(bisect.bisect_right(starts, ws) - 1, 0)
            while j < len(self.busy) and self.busy[j][0] < we:
                s, e = self.busy[j]
                j += 1
                if e <= ws:
                    continue
                if s > t:
                    gaps.append((t, s))
                t = max(t, e)
            if we > t:
                gaps.append((t, we))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) / 2
            open_ = [h for h in self.host if h[1] <= mid <= h[2]]
            name = max(open_, key=lambda h: h[1])[0] if open_ else "outside spans"
            out.append([name, (e - s) / 1e6])
        return out


def _union(spans: list) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _clip(spans: list, windows: list, merge: bool = True) -> list:
    """The parts of `spans` inside `windows` (sorted and disjoint)."""
    starts = [w[0] for w in windows]
    out = []
    for s, e in spans:
        j = max(bisect.bisect_right(starts, s) - 1, 0)
        while j < len(windows) and windows[j][0] < e:
            a, b = max(s, windows[j][0]), min(e, windows[j][1])
            if a < b:
                out.append((a, b))
            j += 1
    return _union(out) if merge else out
