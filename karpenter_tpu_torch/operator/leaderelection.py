"""Store-backed leader election.

The reference delegates HA to controller-runtime's Lease-based leader
election against the API server (pkg/operator/operator.go:144-151:
LeaseDuration 15s / RenewDeadline 10s / RetryPeriod 2s, lease name
"karpenter-leader-election"). The TPU-native equivalent coordinates
through the Store — the durable substrate every controller already
trusts: a Lease object carries the holder identity and renew time, and
acquire/renew/takeover go through resource-version CAS (`update` with
`expect_version`) so two operators sharing one store race safely. A
non-leader operator keeps its informer warm but runs no write-side
controllers; it takes over once the incumbent's lease goes stale.
"""

from __future__ import annotations

import copy
import uuid
from dataclasses import dataclass, field
from typing import Optional

from karpenter_tpu_torch.apis.core import ObjectMeta
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.runtime.store import AlreadyExists, Conflict, Store
from karpenter_tpu_torch.utils.clock import Clock

LEASE_NAME = "karpenter-leader-election"
# controller-runtime defaults the reference inherits
LEASE_DURATION = 15.0

_log = klog.logger("leaderelection")

_MASTER_STATUS = global_registry.gauge(
    "leader_election_master_status",
    "1 when this operator holds the leader lease",
    labels=["name"],
)


@dataclass
class LeaseSpec:
    holder_identity: str = ""
    lease_duration_seconds: float = LEASE_DURATION
    acquire_time: float = 0.0
    renew_time: float = 0.0


@dataclass
class Lease:
    KIND = "Lease"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(name=LEASE_NAME))
    spec: LeaseSpec = field(default_factory=LeaseSpec)


class LeaderElector:
    """Acquire-or-renew once per operator pass (the pass interval plays the
    role of the reference's 2s RetryPeriod)."""

    def __init__(
        self,
        store: Store,
        clock: Clock,
        identity: Optional[str] = None,
        identity_prefix: str = "karpenter",
        lease_duration: float = LEASE_DURATION,
        enabled: bool = True,
    ):
        self.store = store
        self.clock = clock
        self.identity = identity or f"{identity_prefix}-{uuid.uuid4().hex[:8]}"
        self.lease_duration = lease_duration
        self.enabled = enabled
        self._leading = False

    def is_leader(self) -> bool:
        return not self.enabled or self._leading

    def try_acquire_or_renew(self) -> bool:
        if not self.enabled:
            return True
        now = self.clock.now()
        lease = self.store.try_get("Lease", LEASE_NAME)
        if lease is None:
            fresh = Lease()
            fresh.spec = LeaseSpec(
                holder_identity=self.identity,
                lease_duration_seconds=self.lease_duration,
                acquire_time=now,
                renew_time=now,
            )
            try:
                self.store.create(fresh)
            except AlreadyExists:
                return self._lost()
            return self._won("acquired")
        # never mutate the live store object: the CAS below is only
        # meaningful against a private copy (the informer deepcopies for
        # the same aliasing reason)
        observed_version = lease.metadata.resource_version
        lease = copy.deepcopy(lease)
        if lease.spec.holder_identity == self.identity:
            lease.spec.renew_time = now
            try:
                self.store.update(lease, expect_version=observed_version)
            except Conflict:
                return self._lost()
            return self._won(None)
        if (
            lease.spec.holder_identity
            and now - lease.spec.renew_time < lease.spec.lease_duration_seconds
        ):
            return self._lost()
        # incumbent went stale: take over via CAS
        previous = lease.spec.holder_identity
        lease.spec.holder_identity = self.identity
        lease.spec.acquire_time = now
        lease.spec.renew_time = now
        lease.spec.lease_duration_seconds = self.lease_duration
        try:
            self.store.update(lease, expect_version=observed_version)
        except Conflict:
            return self._lost()
        return self._won("took over from stale holder", previous=previous)

    def release(self) -> None:
        """Clean-shutdown release so a standby takes over immediately
        (controller-runtime's ReleaseOnCancel)."""
        if not self.enabled or not self._leading:
            return
        lease = self.store.try_get("Lease", LEASE_NAME)
        if lease is not None and lease.spec.holder_identity == self.identity:
            observed_version = lease.metadata.resource_version
            lease = copy.deepcopy(lease)
            lease.spec.holder_identity = ""
            lease.spec.renew_time = 0.0
            try:
                self.store.update(lease, expect_version=observed_version)
            except Conflict:
                pass
        self._leading = False
        _MASTER_STATUS.set(0.0, {"name": self.identity})

    def _won(self, how: Optional[str], **extra) -> bool:
        if how is not None and not self._leading:
            _log.info(f"{how} leader lease", identity=self.identity, **extra)
        self._leading = True
        _MASTER_STATUS.set(1.0, {"name": self.identity})
        return True

    def _lost(self) -> bool:
        if self._leading:
            _log.info("lost leader lease", identity=self.identity)
        self._leading = False
        _MASTER_STATUS.set(0.0, {"name": self.identity})
        return False
