"""Event recorder with dedup + per-reason rate limiting.

Mirrors the reference's pkg/events/recorder.go:30-117: identical events are
deduplicated for a TTL window, and reasons can carry a token-bucket rate
limit so controllers can't flood the event stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from karpenter_tpu_torch.utils.clock import Clock

DEDUPE_TTL = 120.0  # seconds (recorder.go:40)


@dataclass
class Event:
    involved_object: Any
    type: str  # "Normal" | "Warning"
    reason: str
    message: str
    dedupe_values: tuple = ()
    timestamp: float = 0.0

    def dedupe_key(self) -> tuple:
        if self.dedupe_values:
            return (self.reason,) + tuple(self.dedupe_values)
        obj = self.involved_object
        name = getattr(obj.metadata, "name", "") if obj is not None else ""
        return (self.type, self.reason, self.message, name)


class _TokenBucket:
    def __init__(self, rate: float, burst: int, clock: Clock):
        self.rate = rate
        self.burst = burst
        self.tokens = float(burst)
        self.last = clock.now()
        self.clock = clock

    def allow(self) -> bool:
        now = self.clock.now()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class Recorder:
    """Publishes events, dropping duplicates within the TTL window."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self._seen: dict[tuple, float] = {}
        self._limiters: dict[str, _TokenBucket] = {}
        self.events: list[Event] = []

    def rate_limit(self, reason: str, rate: float = 1.0, burst: int = 10) -> None:
        self._limiters[reason] = _TokenBucket(rate, burst, self.clock)

    def publish(self, *events: Event) -> None:
        for event in events:
            key = event.dedupe_key()
            now = self.clock.now()
            self._maybe_evict(now)
            last = self._seen.get(key)
            if last is not None and now - last < DEDUPE_TTL:
                continue
            limiter = self._limiters.get(event.reason)
            if limiter is not None and not limiter.allow():
                continue
            self._seen[key] = now
            event.timestamp = now
            self.events.append(event)

    def _maybe_evict(self, now: float) -> None:
        """Prune expired dedupe entries so the map is bounded by the TTL
        window (the reference uses an expiring cache, recorder.go:48-58).

        port: a prune runs once the map has doubled since the last one
        (first at 4096 entries). The reference prunes on every publish past
        4096, a copy of the whole map each time: with tens of thousands of
        distinct keys inside the window (a 50k-pod batch's Nominated
        events) that is quadratic. An expired entry never dedupes, so the
        events published are the same."""
        if len(self._seen) < getattr(self, "_evict_at", 4096):
            return
        self._seen = {k: t for k, t in self._seen.items() if now - t < DEDUPE_TTL}
        self._evict_at = max(4096, 2 * len(self._seen))

    def reset(self) -> None:
        self.events.clear()
        self._seen.clear()

    def calls(self, reason: str) -> int:
        return sum(1 for e in self.events if e.reason == reason)
