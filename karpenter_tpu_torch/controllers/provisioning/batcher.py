"""Pod batching window: idle / max-duration, deduped by element.

Mirrors the reference's provisioning/batcher.go:28-110 translated from
channel-select to logical time: the cooperative controller loop polls
`ready()` instead of blocking on timers, so fake clocks drive it in tests
exactly like the reference's fake timers.
"""

from __future__ import annotations

from typing import Generic, Hashable, Optional, TypeVar

from karpenter_tpu_torch.utils.clock import Clock

T = TypeVar("T", bound=Hashable)


class Batcher(Generic[T]):
    def __init__(self, clock: Clock, idle_duration: float = 1.0, max_duration: float = 10.0):
        self.clock = clock
        self.idle_duration = idle_duration
        self.max_duration = max_duration
        # elem -> first trigger time within the current window: the
        # "first-seen-pending" instant each pod's scheduling-journey trace
        # starts from (tracing's pod.pending span)
        self._elems: dict[T, float] = {}
        self._first_trigger = 0.0
        self._last_trigger = 0.0

    def trigger(self, elem: T) -> None:
        if elem in self._elems:
            return
        now = self.clock.now()
        if not self._elems:
            self._first_trigger = now
        self._last_trigger = now
        self._elems[elem] = now

    def ready(self) -> bool:
        """The window closed: idle since last trigger, or max age reached."""
        if not self._elems:
            return False
        now = self.clock.now()
        return (
            now - self._last_trigger >= self.idle_duration
            or now - self._first_trigger >= self.max_duration
        )

    def consume(self) -> Optional[dict[T, float]]:
        """Take the batch if ready, clearing it (the Wait() return).
        Returns each element's first-trigger time — the pending-wait start
        the provisioner's trace records — or None when not ready. A ready
        batch is never empty, so the return stays truthy exactly when the
        old boolean was."""
        if not self.ready():
            return None
        taken = self._elems
        self._elems = {}
        return taken

    def __len__(self) -> int:
        return len(self._elems)
