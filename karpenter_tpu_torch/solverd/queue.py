"""Bounded admission queue: depth-limited, deadline-aware, tenant-fair,
shed-not-block.

An overloaded solver must reject work instead of stalling the controller
loop behind it (the reference's controllers assume reconcile passes stay
bounded). offer() is O(1) and never blocks: a full queue raises
QueueFullError immediately, a request past its deadline raises
DeadlineExceededError, and drain() expires queued entries whose deadline
passed while they waited — expired work is returned separately so the
service can fail it without executing it.

Multi-tenant discipline (the fleet serving many clusters): an optional
per-tenant quota caps how much of the queue any one tenant may occupy —
the noisy tenant is shed with a typed TenantQuotaExceededError while the
quiet tenant's headroom stays untouched — and drain() orders a mixed batch
by weighted fair queuing (per-tenant virtual finish times) so a burst from
one tenant cannot push another's requests to the back of every batch.
Single-tenant batches keep exact FIFO order, so the default deployment is
byte-for-byte unchanged.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.solverd.api import (
    DeadlineExceededError,
    QueueFullError,
    TenantQuotaExceededError,
)
from karpenter_tpu_torch.utils.clock import Clock

_DEPTH = global_registry.gauge(
    "karpenter_solverd_queue_depth", "solve requests waiting for a batch"
)
_REJECTIONS = global_registry.counter(
    "karpenter_solverd_rejections_total",
    "solve requests shed by admission control",
    labels=["reason"],
)
_TENANT_SHEDS = global_registry.counter(
    "karpenter_solverd_tenant_sheds_total",
    "solve requests shed because the tenant's queue quota was exhausted",
    labels=["tenant"],
)
_TENANT_ADMITTED = global_registry.counter(
    "karpenter_solverd_tenant_admitted_total",
    "solve requests admitted per tenant",
    labels=["tenant"],
)


def parse_tenant_weights(raw: str) -> dict[str, float]:
    """"gold=4,free=1" -> {"gold": 4.0, "free": 1.0}; unlisted tenants
    weigh 1.0. Non-positive weights are clamped to the default."""
    out: dict[str, float] = {}
    for part in filter(None, (p.strip() for p in (raw or "").split(","))):
        name, _, value = part.partition("=")
        try:
            weight = float(value)
        except ValueError:
            continue
        if weight > 0:
            out[name.strip()] = weight
    return out


class AdmissionQueue:
    def __init__(
        self,
        clock: Clock,
        max_depth: int = 256,
        tenant_quota: int = 0,
        tenant_weights: Optional[dict[str, float]] = None,
    ):
        self.clock = clock
        self.max_depth = max_depth
        # 0 disables the quota; N caps any one tenant at N queued entries
        self.tenant_quota = tenant_quota
        self.tenant_weights = dict(tenant_weights or {})
        self._items: deque = deque()
        self._tenant_depth: dict[str, int] = {}
        self._lock = threading.Lock()

    def _tenant(self, entry) -> str:
        return getattr(entry.request, "tenant", "") or ""

    def offer(self, entry) -> None:
        """Admit `entry` (anything with a `.request`) or raise a typed
        rejection. Never blocks."""
        now = self.clock.now()
        deadline = entry.request.deadline
        if deadline is not None and now > deadline:
            _REJECTIONS.inc({"reason": "deadline"})
            raise DeadlineExceededError(
                f"deadline passed {now - deadline:.3f}s before admission"
            )
        tenant = self._tenant(entry)
        with self._lock:
            if len(self._items) >= self.max_depth:
                _REJECTIONS.inc({"reason": "queue_full"})
                raise QueueFullError(
                    f"admission queue at depth {self.max_depth}"
                )
            if (
                self.tenant_quota > 0
                and self._tenant_depth.get(tenant, 0) >= self.tenant_quota
            ):
                _REJECTIONS.inc({"reason": "tenant_quota"})
                _TENANT_SHEDS.inc({"tenant": tenant})
                raise TenantQuotaExceededError(
                    f"tenant {tenant!r} at quota "
                    f"{self.tenant_quota}/{self.max_depth} queued solves"
                )
            entry.enqueued_at = now
            self._items.append(entry)
            self._tenant_depth[tenant] = self._tenant_depth.get(tenant, 0) + 1
            _DEPTH.set(float(len(self._items)))
        _TENANT_ADMITTED.inc({"tenant": tenant})

    def _fair_order(self, entries: list) -> list:
        """Weighted fair queuing over the drained batch: the k-th entry of a
        tenant gets virtual finish time (k+1)/weight, and the batch executes
        in virtual-finish order (ties broken by tenant name, then arrival)
        — a tenant with weight 2 lands twice as many entries early as a
        tenant with weight 1, and no tenant waits behind another's entire
        burst. Pure function of (arrival order, weights): deterministic.
        Batches with fewer than two tenants keep exact FIFO order."""
        tenants = {self._tenant(e) for e in entries}
        if len(tenants) < 2:
            return entries
        seen: dict[str, int] = {}
        keyed = []
        for arrival, entry in enumerate(entries):
            tenant = self._tenant(entry)
            k = seen.get(tenant, 0)
            seen[tenant] = k + 1
            weight = self.tenant_weights.get(tenant, 1.0)
            keyed.append(((k + 1) / weight, tenant, arrival, entry))
        keyed.sort(key=lambda item: item[:3])
        return [entry for *_ignored, entry in keyed]

    def drain(self) -> tuple[list, list]:
        """Take everything queued: (ready, expired). Entries whose deadline
        passed while queued come back in `expired` — the caller fails them
        with DeadlineExceededError instead of running them. `ready` is in
        weighted-fair order when the batch spans tenants (FIFO otherwise)."""
        with self._lock:
            taken = list(self._items)
            self._items.clear()
            self._tenant_depth.clear()
            _DEPTH.set(0.0)
        now = self.clock.now()
        ready, expired = [], []
        for entry in taken:
            deadline = entry.request.deadline
            if deadline is not None and now > deadline:
                _REJECTIONS.inc({"reason": "deadline"})
                expired.append(entry)
            else:
                ready.append(entry)
        return self._fair_order(ready), expired

    def remove(self, entries) -> list:
        """Un-admit still-queued entries (identity match); returns the
        entries actually removed. A batched submitter that sheds mid-group
        uses this so the next drain doesn't execute probes the caller has
        already abandoned — entries a concurrent leader drained first are
        simply not found (absent from the return) and run to completion;
        the caller must release only the returned entries' side state
        (dedup slots), never the drained ones'."""
        targets = {id(e) for e in entries}
        with self._lock:
            kept, removed = deque(), []
            for entry in self._items:
                (removed if id(entry) in targets else kept).append(entry)
            if removed:
                self._items = kept
                self._tenant_depth.clear()
                for entry in kept:
                    tenant = self._tenant(entry)
                    self._tenant_depth[tenant] = (
                        self._tenant_depth.get(tenant, 0) + 1
                    )
            _DEPTH.set(float(len(self._items)))
        return removed

    def depth(self) -> int:
        with self._lock:
            return len(self._items)

    def tenant_depths(self) -> dict[str, int]:
        with self._lock:
            return dict(self._tenant_depth)
