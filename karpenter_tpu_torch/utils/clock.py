"""Injectable clock, mirroring the reference's use of k8s.io/utils/clock.

Every controller takes a Clock so tests can drive time deterministically
(reference test pattern: clock.NewFakeClock in every suite_test.go).
"""

from __future__ import annotations

import threading
import time


class Clock:
    def now(self) -> float:
        return time.time()

    def since(self, t: float) -> float:
        return self.now() - t

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class FakeClock(Clock):
    """Settable clock for tests (k8s.io/utils/clock/testing.FakeClock).

    Two sleep disciplines share one time source:

    - Default (controller tests): ``sleep`` advances virtual time itself —
      the sleeping code IS the thing driving time, so it steps and returns.
    - Driver mode (``enable_blocking_sleep``): one thread — the simulator's
      event loop — owns time. ``sleep`` called from the driver still steps
      (it would otherwise deadlock against itself), but ``sleep`` from any
      OTHER thread registers a waiter and blocks until the driver advances
      virtual time past its deadline. No busy-waiting: waiters park on a
      condition variable that ``step``/``set_time`` notify.
    """

    def __init__(self, start: float = 1_000_000.0):
        self._now = start
        self._cond = threading.Condition()
        self._driver: threading.Thread | None = None
        # deadlines of currently-blocked sleepers, for introspection: the
        # simulator can advance straight to the earliest wakeup
        self._waiters: list[float] = []

    def now(self) -> float:
        return self._now

    def __getstate__(self) -> dict:
        # The condition variable, driver thread, and parked waiters are
        # process-local runtime state. A pickled clock travels as just its
        # current time — the socket transport ships schedulers that embed
        # their clock, and the receiving daemon gets a fresh, idle one.
        return {"_now": self._now}

    def __setstate__(self, state: dict) -> None:
        self._now = state["_now"]
        self._cond = threading.Condition()
        self._driver = None
        self._waiters = []

    def enable_blocking_sleep(self, driver: threading.Thread | None = None) -> None:
        """Worker-thread sleeps now block until virtual time passes. The
        driver thread (default: the caller's) keeps step-on-sleep semantics
        so the thread advancing time can never deadlock on itself."""
        with self._cond:
            self._driver = driver or threading.current_thread()

    def disable_blocking_sleep(self) -> None:
        with self._cond:
            self._driver = None
            self._cond.notify_all()

    def sleep(self, seconds: float) -> None:
        if seconds <= 0:
            return
        with self._cond:
            if self._driver is None or self._driver is threading.current_thread():
                self._advance(seconds)
                return
            deadline = self._now + seconds
            self._waiters.append(deadline)
            try:
                while self._now < deadline and self._driver is not None:
                    self._cond.wait()
            finally:
                self._waiters.remove(deadline)

    def step(self, seconds: float) -> None:
        with self._cond:
            self._advance(seconds)

    def set_time(self, t: float) -> None:
        with self._cond:
            self._now = t
            self._cond.notify_all()

    def _advance(self, seconds: float) -> None:
        self._now += seconds
        self._cond.notify_all()

    # -- waiter introspection (simulator event loop) ------------------------

    def waiter_count(self) -> int:
        with self._cond:
            return len(self._waiters)

    def next_wakeup(self) -> float | None:
        """Earliest blocked sleeper's deadline, or None."""
        with self._cond:
            return min(self._waiters) if self._waiters else None
