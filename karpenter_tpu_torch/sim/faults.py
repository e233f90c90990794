"""Fault-injection layer: wrappers around the CloudProvider and the solverd
client plus scheduled-interruption executors.

All randomness comes from seeded ``random.Random`` streams owned by the
harness, so fault sequences replay exactly. Wrappers report every injection
through an ``on_fault`` callback that the harness routes into the event log
— faults are part of the scenario's observable record, not hidden state.
"""

from __future__ import annotations

from random import Random
from typing import Callable, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    CreateError,
    InsufficientCapacityError,
)
from karpenter_tpu_torch.solverd import QueueFullError, SolverClient
from karpenter_tpu_torch.utils.clock import Clock

OnFault = Callable[..., None]


def _noop_on_fault(ev: str, **fields) -> None:
    pass


class CloudOutageError(Exception):
    """Total cloud-API outage: create/delete fail untyped, the way a real
    region event looks to a controller. Deliberately NOT one of the typed
    domain errors — the lifecycle controller does not catch it, so it
    propagates to the reconciler harness (per-item backoff) and counts as
    a retryable failure for the circuit breaker."""


class FaultyCloudProvider(CloudProvider):
    """Wraps any CloudProvider with probabilistic launch failures, API
    latency, and scheduled full-API outage windows. Latency advances
    VIRTUAL time (clock.sleep) — under the simulator's FakeClock the whole
    control loop experiences a slow cloud API without any wall-clock
    cost."""

    def __init__(
        self,
        inner: CloudProvider,
        rng: Random,
        clock: Clock,
        launch_failure_rate: float = 0.0,
        insufficient_capacity_rate: float = 0.0,
        ack_then_raise_rate: float = 0.0,
        api_latency: float = 0.0,
        api_jitter: float = 0.0,
        outages: Optional[list[tuple[float, float]]] = None,
        on_fault: Optional[OnFault] = None,
    ):
        self.inner = inner
        self.rng = rng
        self.clock = clock
        self.launch_failure_rate = launch_failure_rate
        self.insufficient_capacity_rate = insufficient_capacity_rate
        self.ack_then_raise_rate = ack_then_raise_rate
        self.api_latency = api_latency
        self.api_jitter = api_jitter
        # absolute virtual-time [start, end) windows where EVERY
        # create/delete raises CloudOutageError
        self.outages = list(outages or [])
        self.on_fault = on_fault or _noop_on_fault
        self.launch_failures = 0
        self.capacity_errors = 0
        self.ack_then_raise_failures = 0
        self.outage_failures = 0

    def _lag(self) -> None:
        if self.api_latency <= 0 and self.api_jitter <= 0:
            return
        self.clock.sleep(self.api_latency + self.api_jitter * self.rng.random())

    def _outage(self, op: str, node_claim) -> None:
        now = self.clock.now()
        if any(start <= now < end for start, end in self.outages):
            self.outage_failures += 1
            self.on_fault(
                "fault-outage", op=op, nodeclaim=node_claim.metadata.name
            )
            raise CloudOutageError(f"sim: injected cloud outage ({op})")

    def create(self, node_claim):
        self._lag()
        self._outage("create", node_claim)
        roll = self.rng.random()
        if roll < self.launch_failure_rate:
            self.launch_failures += 1
            self.on_fault("fault-launch", nodeclaim=node_claim.metadata.name)
            raise CreateError(
                "sim: injected launch failure",
                condition_reason="SimInjectedFault",
            )
        if roll < self.launch_failure_rate + self.insufficient_capacity_rate:
            self.capacity_errors += 1
            self.on_fault("fault-ice", nodeclaim=node_claim.metadata.name)
            raise InsufficientCapacityError("sim: injected capacity shortage")
        threshold = (
            self.launch_failure_rate
            + self.insufficient_capacity_rate
            + self.ack_then_raise_rate
        )
        if roll < threshold:
            # the ambiguous failure: the cloud API acknowledges — the
            # instance MATERIALIZES — but the response is lost. A third
            # band of the same single roll, so rate 0 keeps existing
            # scenario digests byte-identical. The retry must converge via
            # the launch idempotency key, never a second instance.
            self.inner.create(node_claim)
            self.ack_then_raise_failures += 1
            self.on_fault("fault-ack-raise", nodeclaim=node_claim.metadata.name)
            raise CreateError(
                "sim: injected ambiguous ack (create landed, response lost)",
                condition_reason="SimAmbiguousAck",
            )
        return self.inner.create(node_claim)

    def delete(self, node_claim):
        self._lag()
        self._outage("delete", node_claim)
        return self.inner.delete(node_claim)

    def get(self, provider_id: str):
        return self.inner.get(provider_id)

    def list(self):
        return self.inner.list()

    def get_instance_types(self, node_pool):
        return self.inner.get_instance_types(node_pool)

    def is_drifted(self, node_claim) -> str:
        return self.inner.is_drifted(node_claim)

    def repair_policies(self):
        return self.inner.repair_policies()

    def name(self) -> str:
        return self.inner.name()

    def __getattr__(self, attr):
        # tick(), reclaim(), honor_overlays... pass through to the wrapped
        # provider so the operator sees the full surface
        if attr == "inner":
            raise AttributeError(attr)
        return getattr(self.inner, attr)


class FlakySolverClient(SolverClient):
    """Wraps the provisioner's solverd client with a probabilistic
    rejection storm — the degradation path a saturated (or restarting)
    solver daemon inflicts on its controllers."""

    transport = "flaky"

    def __init__(
        self,
        inner: SolverClient,
        rng: Random,
        rejection_rate: float = 0.0,
        on_fault: Optional[OnFault] = None,
    ):
        self.inner = inner
        self.rng = rng
        self.rejection_rate = rejection_rate
        self.on_fault = on_fault or _noop_on_fault
        self.rejections = 0

    def solve(self, kind, scheduler, pods, timeout=None, deadline=None,
              request_id=None, tenant=None):
        if self.rng.random() < self.rejection_rate:
            self.rejections += 1
            self.on_fault("fault-solver-reject", kind=kind, pods=len(list(pods)))
            raise QueueFullError("sim: injected rejection storm")
        return self.inner.solve(
            kind, scheduler, pods, timeout=timeout, deadline=deadline,
            request_id=request_id, tenant=tenant,
        )

    def stats(self) -> dict:
        stats = dict(self.inner.stats())
        stats["injected_rejections"] = self.rejections
        return stats

    def close(self) -> None:
        self.inner.close()


# -- scheduled interruptions --------------------------------------------------


def interrupt(
    store,
    provider,
    rng: Random,
    count: int = 1,
    mode: str = "graceful",
    capacity_type: Optional[str] = None,
    on_fault: Optional[OnFault] = None,
) -> int:
    """Interrupt up to ``count`` launched instances.

    graceful — the two-minute spot interruption notice: delete the
    NodeClaim so the normal drain → terminate → replace pipeline runs
    (what the interruption controller does on an SQS notice).

    reclaim — the cloud takes the capacity back out-of-band: the instance
    vanishes from the provider (kwok ``reclaim``) and its Node object
    drops out of the cluster; the GC controller later reaps the orphaned
    claim and the provisioner replaces the lost capacity.

    Victims are drawn deterministically (name-sorted, seeded rng) from
    launched claims matching the capacity-type filter. Returns the number
    of instances actually interrupted."""
    on_fault = on_fault or _noop_on_fault
    claims = [
        c
        for c in store.list("NodeClaim")
        if c.status.provider_id
        and c.metadata.deletion_timestamp is None
        and (
            capacity_type is None
            or c.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY) == capacity_type
        )
    ]
    claims.sort(key=lambda c: c.metadata.name)
    hit = 0
    for _ in range(min(count, len(claims))):
        victim = claims.pop(rng.randrange(len(claims)))
        if mode == "reclaim":
            if not provider.reclaim(victim.status.provider_id):
                continue
            # the node drops off the cluster with the instance
            for node in store.list(
                "Node",
                predicate=lambda n: n.spec.provider_id == victim.status.provider_id,
            ):
                node.metadata.finalizers = []
                store.delete(node)
            on_fault(
                "fault-reclaim",
                nodeclaim=victim.metadata.name,
                provider_id=victim.status.provider_id,
            )
        else:
            store.delete(victim)
            on_fault(
                "fault-interrupt",
                nodeclaim=victim.metadata.name,
                provider_id=victim.status.provider_id,
            )
        hit += 1
    return hit
