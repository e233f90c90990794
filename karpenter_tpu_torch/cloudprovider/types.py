"""CloudProvider plugin boundary: interface, InstanceType/Offering model,
typed errors. Mirrors reference pkg/cloudprovider/types.go:64-443.
"""

from __future__ import annotations

import math
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from functools import cached_property
from typing import TYPE_CHECKING, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.scheduling.requirements import (
    Operator,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList

if TYPE_CHECKING:
    from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_tpu_torch.apis.nodepool import NodePool

# Label injected into a reserved offering's requirements to uniquely identify
# a reservation (types.go:44-49); registered well-known in apis/labels so
# claims are compatible with reserved offerings without defining it.
RESERVATION_ID_LABEL = wk.RESERVATION_ID_LABEL_KEY

SPOT_REQUIREMENT = Requirements(
    Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [wk.CAPACITY_TYPE_SPOT])
)
ON_DEMAND_REQUIREMENT = Requirements(
    Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [wk.CAPACITY_TYPE_ON_DEMAND])
)
RESERVED_REQUIREMENT = Requirements(
    Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [wk.CAPACITY_TYPE_RESERVED])
)


@dataclass
class RepairPolicy:
    condition_type: str
    condition_status: str
    toleration_duration: float  # seconds


@dataclass
class Offering:
    """Where an InstanceType is available (zone × capacity-type × price).

    Requirements must contain the capacity-type and zone keys
    (types.go:255-276).
    """

    requirements: Requirements
    price: float
    available: bool = True
    reservation_capacity: int = 0

    # cached: requirements are immutable and these run in per-pod loops
    # (dataclass repr/eq use declared fields only, so the cache is inert)
    @cached_property
    def capacity_type(self) -> str:
        return self.requirements.get(wk.CAPACITY_TYPE_LABEL_KEY).any()

    @cached_property
    def zone(self) -> str:
        return self.requirements.get(wk.LABEL_TOPOLOGY_ZONE).any()

    @cached_property
    def reservation_id(self) -> str:
        return self.requirements.get(RESERVATION_ID_LABEL).any()


class Offerings(list):
    """Offering list helpers (types.go:278-332)."""

    def available(self) -> "Offerings":
        return Offerings(o for o in self if o.available)

    def compatible(self, reqs: Requirements) -> "Offerings":
        return Offerings(
            o
            for o in self
            if reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
        )

    def has_compatible(self, reqs: Requirements) -> bool:
        return any(
            reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
            for o in self
        )

    def cheapest(self) -> Optional[Offering]:
        return min(self, key=lambda o: o.price, default=None)

    def most_expensive(self) -> Optional[Offering]:
        return max(self, key=lambda o: o.price, default=None)

    def worst_launch_price(self, reqs: Requirements) -> float:
        """Worst-case launch price by capacity-type precedence
        reserved → spot → on-demand (types.go:318-332)."""
        for ct_reqs in (RESERVED_REQUIREMENT, SPOT_REQUIREMENT, ON_DEMAND_REQUIREMENT):
            compat = self.compatible(reqs).compatible(ct_reqs)
            if compat:
                return compat.most_expensive().price
        return math.inf


@dataclass
class InstanceTypeOverhead:
    kube_reserved: ResourceList = field(default_factory=dict)
    system_reserved: ResourceList = field(default_factory=dict)
    eviction_threshold: ResourceList = field(default_factory=dict)

    def total(self) -> ResourceList:
        return res.merge(self.kube_reserved, self.system_reserved, self.eviction_threshold)


class InstanceType:
    """A potential node shape (types.go:96-125)."""

    def __init__(
        self,
        name: str,
        requirements: Requirements,
        offerings: Offerings | Sequence[Offering],
        capacity: ResourceList,
        overhead: Optional[InstanceTypeOverhead] = None,
    ):
        self.name = name
        self.requirements = requirements
        self.offerings = Offerings(offerings)
        self.capacity = capacity
        self.overhead = overhead or InstanceTypeOverhead()
        self._allocatable: Optional[ResourceList] = None

    def allocatable(self) -> ResourceList:
        if self._allocatable is None:
            self._allocatable = res.subtract(self.capacity, self.overhead.total())
        return self._allocatable

    @cached_property
    def has_reserved_offerings(self) -> bool:
        """Whether ANY offering is reserved-capacity — lets per-pod loops
        skip the offering scan for the (typical) all-unreserved catalog."""
        return any(
            o.capacity_type == wk.CAPACITY_TYPE_RESERVED for o in self.offerings
        )

    def __repr__(self) -> str:
        return f"InstanceType({self.name})"


def order_by_price(
    instance_types: Sequence[InstanceType], reqs: Requirements
) -> list[InstanceType]:
    """Sort by cheapest available compatible offering (types.go:127-146).
    Stable, so equal-price types keep their input order (decision identity)."""

    def price(it: InstanceType) -> float:
        best = math.inf
        for o in it.offerings:
            if (
                o.available
                and reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
                and o.price < best
            ):
                best = o.price
        return best

    return sorted(instance_types, key=price)


def compatible_instance_types(
    instance_types: Sequence[InstanceType], requirements: Requirements
) -> list[InstanceType]:
    """Filter to types with an available compatible offering (types.go:149-157)."""
    return [
        it
        for it in instance_types
        if it.offerings.available().has_compatible(requirements)
    ]


def satisfies_min_values(
    instance_types: Sequence[InstanceType], requirements: Requirements
) -> tuple[int, dict[str, int], Optional[str]]:
    """Minimum instance types needed to satisfy minValues requirements.

    Returns (min_needed, unsatisfiable_keys, error). Mirrors
    types.go:190-224 — order-dependent, callers sort by price first.
    """
    if not requirements.has_min_values():
        return 0, {}, None
    incompatible: dict[str, int] = {}
    values_for_key: dict[str, set[str]] = {}
    min_reqs = [r for r in requirements if r.min_values is not None]
    for i, it in enumerate(instance_types):
        for req in min_reqs:
            values_for_key.setdefault(req.key, set()).update(
                it.requirements.get(req.key).values
            )
        for k, vals in values_for_key.items():
            needed = requirements.get(k).min_values or 0
            if len(vals) < needed:
                incompatible[k] = len(vals)
            else:
                incompatible.pop(k, None)
        if not incompatible:
            return i + 1, {}, None
    if incompatible:
        return (
            len(instance_types),
            incompatible,
            min_values_error(incompatible),
        )
    return len(instance_types), {}, None


def min_values_error(keys) -> str:
    """The user-facing minValues failure text (types.go:218). Shared with the
    device solver's diversity gate (ops/ffd.py _min_fail) — host/device
    decision parity compares error STRINGS, so there must be one source."""
    return f"minValues requirement is not met for label(s) {sorted(keys)}"


def truncate_instance_types(
    instance_types: Sequence[InstanceType],
    requirements: Requirements,
    max_items: int,
    best_effort_min_values: bool = False,
) -> tuple[list[InstanceType], Optional[str]]:
    """Price-ordered truncation honoring minValues (types.go:228-240)."""
    truncated = order_by_price(instance_types, requirements)[:max_items]
    if requirements.has_min_values() and not best_effort_min_values:
        _, _, err = satisfies_min_values(truncated, requirements)
        if err is not None:
            return list(instance_types), f"validating minValues, {err}"
    return truncated, None


# -- typed errors (types.go:334-443) ---------------------------------------


class NodeClaimNotFoundError(Exception):
    pass


class InsufficientCapacityError(Exception):
    pass


class NodeClassNotReadyError(Exception):
    pass


class CreateError(Exception):
    def __init__(self, message: str, condition_reason: str = "", condition_message: str = ""):
        super().__init__(message)
        self.condition_reason = condition_reason
        self.condition_message = condition_message or message


class CircuitBreakerOpenError(CreateError):
    """Fast-fail: the provider circuit breaker is open — the cloud has been
    failing consecutively and calls are shed until the next probe window.
    Subclasses CreateError so launch paths degrade through the normal
    typed-error handling (condition set, claim retried) instead of crashing;
    delete paths surface it to the reconciler harness for backoff."""

    def __init__(self, message: str, retry_after: float = 0.0):
        super().__init__(message, condition_reason="CloudProviderCircuitOpen")
        self.retry_after = retry_after


def is_retryable_error(e: BaseException) -> bool:
    """Whether a cloud call failure is infrastructure-shaped (worth a retry,
    counted by the circuit breaker) rather than a domain answer. Not-found,
    insufficient capacity, and nodeclass-not-ready are the cloud RESPONDING
    — they break a consecutive-failure streak instead of extending it. A
    breaker fast-fail is itself never evidence about the cloud."""
    return not isinstance(
        e,
        (
            NodeClaimNotFoundError,
            InsufficientCapacityError,
            NodeClassNotReadyError,
            CircuitBreakerOpenError,
        ),
    )


class CloudProvider(ABC):
    """The pluggable provider boundary (types.go:64-92)."""

    @abstractmethod
    def create(self, node_claim: "NodeClaim") -> "NodeClaim":
        """Launch a NodeClaim; returns it hydrated with resolved labels.
        Raises InsufficientCapacityError / NodeClassNotReadyError /
        CreateError on failure."""

    @abstractmethod
    def delete(self, node_claim: "NodeClaim") -> None:
        """Terminate; raises NodeClaimNotFoundError once gone."""

    @abstractmethod
    def get(self, provider_id: str) -> "NodeClaim":
        """Fetch by provider id; raises NodeClaimNotFoundError."""

    @abstractmethod
    def list(self) -> list["NodeClaim"]:
        ...

    @abstractmethod
    def get_instance_types(self, node_pool: "NodePool") -> list[InstanceType]:
        """All instance types, including ones with no available offerings."""

    @abstractmethod
    def is_drifted(self, node_claim: "NodeClaim") -> str:
        """Returns a drift reason, or '' if not drifted."""

    def repair_policies(self) -> list[RepairPolicy]:
        return []

    @abstractmethod
    def name(self) -> str:
        ...
