"""The garbage collector's time, from `gc.callbacks`.

A timed unit pays for the collections that run inside it, and for those
that ran since the unit before it ended: what the client did between
units (building the next arrivals) triggers them, but what they free is
mostly the system's garbage, which a controller's own heap would carry.
In a traced window, each collection of generation 1 or 2 is also a span
`gc`, so the device trace counts the time the units pay for outside
their own spans.
"""

from __future__ import annotations

import gc
import time

from benchmark.harness.trace import GC_SPAN


class GcClock:
    def __init__(self, tracer=None):
        self.total = 0.0  # seconds inside collections since start()
        self.collections = 0
        self.tracer = tracer
        self._t0 = 0.0
        self._span = None

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            if self.tracer is not None and self.tracer.active and info["generation"] >= 1:
                self._span = self.tracer.span(GC_SPAN)
                self._span.__enter__()
            self._t0 = time.perf_counter()
        else:
            self.total += time.perf_counter() - self._t0
            self.collections += 1
            if self._span is not None:
                self._span.__exit__(None, None, None)
                self._span = None

    def start(self) -> None:
        gc.callbacks.append(self._callback)

    def stop(self) -> None:
        if self._callback in gc.callbacks:
            gc.callbacks.remove(self._callback)
