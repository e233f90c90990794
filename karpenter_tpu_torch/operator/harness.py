"""Reconciler harness: fault isolation, backoff requeue, and health state.

Mirrors what controller-runtime gives every reference controller for free
(pkg/internal/controller/controller.go): panic recovery around each
Reconcile, a per-item rate-limited workqueue with exponential backoff, and
reconcile error/duration metrics. The TPU build runs ~25 reconciles inline
in one cooperative pass (operator.py:run_once), so the harness supplies the
same guarantees at the call sites:

- ``Reconciler``: a named wrapper every controller registers with. One
  controller's uncaught exception increments
  ``karpenter_reconcile_errors_total{controller=...}``, backs off that item,
  and the pass CONTINUES — a misbehaving reconcile never takes down the
  loop.
- ``Result(requeue_after=...)``: typed reconcile result; a controller can
  defer its own next run without faking an error.
- ``BackoffRateLimiter``: per-item exponential backoff with jitter, driven
  by the injected ``Clock`` — under FakeClock (tests, the simulator) the
  whole retry schedule is virtual-time deterministic; jitter draws come
  from a fixed-seed stream so same-seed sim runs stay byte-identical.
- ``CircuitBreaker``: the closed → open → half-open state machine the
  cloud-provider wrapper (cloudprovider/breaker.py) drives, so a broken
  cloud fast-fails instead of being hammered every pass.

The harness is also the operator's health ledger: last-successful-pass
time and per-controller consecutive-failure counts feed
``Operator.health_snapshot`` (served at /healthz and /debug/health).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from random import Random
from typing import Any, Callable, Optional

from karpenter_tpu_torch import tracing
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.utils.clock import Clock

_log = klog.logger("operator.harness")

RECONCILE_TOTAL = global_registry.counter(
    "karpenter_reconcile_total",
    "total reconcile attempts, by controller",
    labels=["controller"],
)
RECONCILE_ERRORS = global_registry.counter(
    "karpenter_reconcile_errors_total",
    "reconcile attempts that raised, by controller",
    labels=["controller"],
)
RECONCILE_DURATION = global_registry.histogram(
    "karpenter_reconcile_duration_seconds",
    "reconcile wall-clock duration, by controller",
    labels=["controller"],
)
RECONCILE_REQUEUES = global_registry.counter(
    "karpenter_reconcile_requeues_total",
    "reconciles skipped because the item is backed off or deferred",
    labels=["controller"],
)

# consecutive failures at which a controller marks the operator degraded
DEGRADED_AFTER = 3
# a leader that hasn't completed a pass in this long is wedged
STALE_PASS_AFTER = 60.0


@dataclass
class Result:
    """Typed reconcile result (controller-runtime's reconcile.Result).

    ``requeue_after`` defers the item's next reconcile without counting as
    a failure; None/absent means "run again whenever the loop comes back".
    """

    requeue_after: Optional[float] = None


class BackoffRateLimiter:
    """Per-item exponential backoff with jitter (client-go's
    ItemExponentialFailureRateLimiter, clock-injected).

    delay(n) = min(cap, base * factor^(n-1)) * (1 + jitter * U[0,1)),
    hard-capped at ``cap``. Success forgets the item entirely. All time
    comes from the injected Clock; all randomness from one fixed-seed
    stream, so the schedule replays exactly under the simulator.
    """

    def __init__(
        self,
        clock: Clock,
        base: float = 1.0,
        cap: float = 120.0,
        factor: float = 2.0,
        jitter: float = 0.5,
        rng: Optional[Random] = None,
    ):
        self.clock = clock
        self.base = base
        self.cap = cap
        self.factor = factor
        self.jitter = jitter
        self.rng = rng or Random("harness:backoff")
        self._failures: dict[Any, int] = {}
        self._not_before: dict[Any, float] = {}

    def failure(self, item: Any) -> float:
        """Record a failure; returns (and schedules) the next delay."""
        n = self._failures.get(item, 0) + 1
        self._failures[item] = n
        raw = self.base * (self.factor ** (n - 1))
        delay = min(self.cap, raw * (1.0 + self.jitter * self.rng.random()))
        self._not_before[item] = self.clock.now() + delay
        self._prune()
        return delay

    def defer(self, item: Any, delay: float) -> None:
        """Explicit requeue (Result.requeue_after) — no failure counted."""
        self._not_before[item] = self.clock.now() + delay

    def success(self, item: Any) -> None:
        self._failures.pop(item, None)
        self._not_before.pop(item, None)

    def allowed(self, item: Any) -> bool:
        return self.clock.now() >= self._not_before.get(item, -float("inf"))

    def retries(self, item: Any) -> int:
        return self._failures.get(item, 0)

    def next_allowed(self, item: Any) -> float:
        return self._not_before.get(item, self.clock.now())

    def _prune(self) -> None:
        # items whose objects were deleted mid-backoff never see success();
        # drop entries long past their window so the maps stay bounded
        if len(self._not_before) < 4096:
            return
        horizon = self.clock.now() - 2 * self.cap
        for item in [i for i, t in self._not_before.items() if t < horizon]:
            self._failures.pop(item, None)
            self._not_before.pop(item, None)


class CircuitBreaker:
    """closed → open → half-open state machine, clock-driven.

    Closed: calls flow; ``record_failure`` counts consecutive retryable
    failures, tripping to open at ``threshold``. Open: ``allow()`` is False
    (callers fast-fail) until ``cooldown`` elapses, then ONE probe is let
    through (half-open). Probe success closes the breaker and resets the
    count; probe failure re-opens it and restarts the cooldown.
    ``threshold <= 0`` disables the breaker (always closed, never counts).
    """

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half-open"

    def __init__(
        self,
        clock: Clock,
        threshold: int = 5,
        cooldown: float = 30.0,
        name: str = "",
    ):
        self.clock = clock
        self.threshold = threshold
        self.cooldown = cooldown
        self.name = name
        self.state = self.CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        self._subscribers: list[Callable[[str, str], None]] = []

    def subscribe(self, callback: Callable[[str, str], None]) -> None:
        """callback(old_state, new_state) on every transition."""
        self._subscribers.append(callback)

    def _transition(self, to: str) -> None:
        old, self.state = self.state, to
        if to == self.OPEN:
            self.opened_at = self.clock.now()
        elif to == self.CLOSED:
            self.opened_at = None
        for callback in self._subscribers:
            callback(old, to)

    def allow(self) -> bool:
        if self.threshold <= 0 or self.state == self.CLOSED:
            return True
        if self.state == self.OPEN:
            if self.clock.now() - (self.opened_at or 0.0) >= self.cooldown:
                self._transition(self.HALF_OPEN)
                return True  # the single half-open probe
            return False
        return False  # half-open: probe already in flight this window

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != self.CLOSED:
            self._transition(self.CLOSED)

    def record_failure(self) -> None:
        if self.threshold <= 0:
            return
        self.consecutive_failures += 1
        if self.state == self.HALF_OPEN:
            self._transition(self.OPEN)
        elif self.state == self.CLOSED and self.consecutive_failures >= self.threshold:
            self._transition(self.OPEN)

    def retry_after(self) -> float:
        """Seconds until the next probe window (0 when not open)."""
        if self.state != self.OPEN or self.opened_at is None:
            return 0.0
        return max(0.0, self.opened_at + self.cooldown - self.clock.now())

    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "state": self.state,
            "enabled": self.threshold > 0,
            "consecutive_failures": self.consecutive_failures,
            "threshold": self.threshold,
            "cooldown_seconds": self.cooldown,
            "opened_at": self.opened_at,
            "retry_after_seconds": round(self.retry_after(), 3),
        }


class Reconciler:
    """A named, isolated controller entry point. Calling it runs the
    wrapped function under the harness: exceptions are caught, counted,
    and backed off per-item; a Result(requeue_after=...) return defers
    the item. Returns the wrapped function's value, or None when the
    call failed or was skipped."""

    def __init__(self, harness: "ReconcilerHarness", name: str, fn: Callable):
        self.harness = harness
        self.name = name
        self.fn = fn

    def __call__(self, *args, item: Optional[str] = None):
        return self.harness._run(self, args, item)


class ReconcilerHarness:
    def __init__(
        self,
        clock: Clock,
        base_delay: float = 1.0,
        max_delay: float = 120.0,
        degraded_after: int = DEGRADED_AFTER,
    ):
        self.clock = clock
        self.limiter = BackoffRateLimiter(clock, base=base_delay, cap=max_delay)
        self.degraded_after = degraded_after
        self.names: list[str] = []
        self._consecutive: dict[str, int] = {}
        self._errors: dict[str, int] = {}
        self._last_error: dict[str, str] = {}
        self.started_at = clock.now()
        self.last_successful_pass: Optional[float] = None
        self.passes = 0

    def register(self, name: str, fn: Callable) -> Reconciler:
        if name not in self.names:
            self.names.append(name)
        return Reconciler(self, name, fn)

    def _run(self, rec: Reconciler, args: tuple, item: Optional[str]):
        key = (rec.name, item or "")
        if not self.limiter.allowed(key):
            RECONCILE_REQUEUES.inc({"controller": rec.name})
            return None
        RECONCILE_TOTAL.inc({"controller": rec.name})
        # every reconcile is a span: the per-hop record a pod's scheduling
        # journey correlates against (controller=, result=, error=), and the
        # source of trace_id/span_id on every log line the call emits
        with tracing.tracer().span(
            "reconcile", controller=rec.name, item=item or ""
        ) as span:
            start = time.perf_counter()
            try:
                result = rec.fn(*args)
            except KernelError as e:
                # port: a device fault is counted as any error is, then
                # raised: the pass fails instead of retrying on a card that
                # faulted (no backoff, no isolation)
                RECONCILE_ERRORS.inc({"controller": rec.name})
                self._consecutive[rec.name] = self._consecutive.get(rec.name, 0) + 1
                self._errors[rec.name] = self._errors.get(rec.name, 0) + 1
                self._last_error[rec.name] = f"{type(e).__name__}: {e}"
                span.fail(e)
                _log.error(
                    "reconcile failed on a device fault",
                    controller=rec.name,
                    item=item or "",
                    error=f"{type(e).__name__}: {e}",
                )
                raise
            except Exception as e:  # noqa: BLE001 — isolation is the point
                RECONCILE_ERRORS.inc({"controller": rec.name})
                delay = self.limiter.failure(key)
                self._consecutive[rec.name] = self._consecutive.get(rec.name, 0) + 1
                self._errors[rec.name] = self._errors.get(rec.name, 0) + 1
                self._last_error[rec.name] = f"{type(e).__name__}: {e}"
                span.fail(e)
                span.set_attr(retries=self.limiter.retries(key))
                _log.error(
                    "reconcile failed",
                    controller=rec.name,
                    item=item or "",
                    error=f"{type(e).__name__}: {e}",
                    retries=self.limiter.retries(key),
                    backoff_seconds=round(delay, 3),
                )
                return None
            finally:
                RECONCILE_DURATION.observe(
                    time.perf_counter() - start, {"controller": rec.name}
                )
            self.limiter.success(key)
            self._consecutive[rec.name] = 0
            if (
                isinstance(result, Result)
                and result.requeue_after is not None
                and result.requeue_after > 0
            ):
                self.limiter.defer(key, result.requeue_after)
                span.set_attr(result="requeue")
            else:
                span.set_attr(result="ok")
            return result

    # -- pass/health accounting ---------------------------------------------

    def note_pass(self) -> None:
        self.passes += 1
        self.last_successful_pass = self.clock.now()

    def degraded_controllers(self) -> list[str]:
        return sorted(
            name
            for name, n in self._consecutive.items()
            if n >= self.degraded_after
        )

    def stale(self) -> bool:
        """No pass completed recently — including NEVER: an operator wedged
        inside its very first pass must go stale too, so the grace window
        runs from construction until the first pass lands."""
        base = (
            self.last_successful_pass
            if self.last_successful_pass is not None
            else self.started_at
        )
        return self.clock.now() - base > STALE_PASS_AFTER

    def snapshot(self) -> dict:
        since = (
            None
            if self.last_successful_pass is None
            else round(self.clock.now() - self.last_successful_pass, 3)
        )
        controllers = {}
        for name in self.names:
            entry: dict = {
                "consecutive_failures": self._consecutive.get(name, 0),
                "errors_total": self._errors.get(name, 0),
            }
            if name in self._last_error:
                entry["last_error"] = self._last_error[name]
            controllers[name] = entry
        return {
            "passes": self.passes,
            "last_successful_pass": self.last_successful_pass,
            "seconds_since_last_pass": since,
            "controllers": controllers,
        }
