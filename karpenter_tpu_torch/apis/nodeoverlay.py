"""NodeOverlay (v1alpha1): price/capacity overlays on instance types.

Mirrors the reference CRD (pkg/apis/v1alpha1/nodeoverlay.go:29-136 and
nodeoverlay_validation.go): a cluster-scoped object whose requirement
selector picks instance types during scheduling simulations, adjusting
offering prices (fixed override, signed delta, or percentage) and appending
extended capacity resources. Weight orders precedence; application happens
at instance-type fetch in the provisioner, gated on the NodeOverlay feature
flag (operator/options.py FeatureGates).

The reference ships the API surface only (application is provider-side);
here application lives in apply_overlays so the kwok/fake providers and the
solver see adjusted catalogs uniformly.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.conditions import ConditionedStatus
from karpenter_tpu_torch.apis.core import ObjectMeta
from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering, Offerings
from karpenter_tpu_torch.scheduling.requirements import (
    Operator,
    Requirements,
    requirements_from_dicts,
)
from karpenter_tpu_torch.utils.resources import ResourceList

# offering-level keys: a selector on these targets individual offerings, not
# whole instance types
_OFFERING_KEYS = frozenset(
    {wk.LABEL_TOPOLOGY_ZONE, wk.CAPACITY_TYPE_LABEL_KEY}
)

# restricted capacity keys (nodeoverlay.go Capacity CEL rule): overlays add
# EXTENDED resources only
RESTRICTED_CAPACITY = frozenset({"cpu", "memory", "ephemeral-storage", "pods"})

_PRICE_RE = re.compile(r"^\d+(\.\d+)?$")
_ADJUSTMENT_RE = re.compile(
    r"^(([+-](\d*\.?\d+))|(\+\d*\.?\d+%)|(-\d{1,2}(\.\d+)?%)|(-100%))$"
)

CONDITION_VALIDATION_SUCCEEDED = "ValidationSucceeded"


@dataclass
class NodeOverlaySpec:
    # NodeSelectorRequirement dicts ({key, operator, values}) constraining
    # when the overlay applies (well-known or nodepool template labels)
    requirements: list[dict] = field(default_factory=list)
    # "+0.5" / "-1.2" fixed delta, "+10%" / "-15%" percentage, or None
    price_adjustment: Optional[str] = None
    # "1.25" absolute price override (mutually exclusive with adjustment)
    price: Optional[str] = None
    # extended resources appended to matching instance types
    capacity: ResourceList = field(default_factory=dict)
    # higher weight wins; ties merge in reverse-alphabetical name order
    weight: int = 0


@dataclass
class NodeOverlayStatus:
    conditions: list = field(default_factory=list)


@dataclass
class NodeOverlay(ConditionedStatus):
    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: NodeOverlaySpec = field(default_factory=NodeOverlaySpec)
    status: NodeOverlayStatus = field(default_factory=NodeOverlayStatus)

    KIND = "NodeOverlay"

    def adjusted_price(self, instance_type_price: float) -> float:
        """nodeoverlay.go:107-136: absolute override wins; otherwise apply
        the delta/percentage; never below zero."""
        spec = self.spec
        if spec.price is None and spec.price_adjustment is None:
            return instance_type_price
        if spec.price is not None:
            return float(spec.price)
        adjustment = spec.price_adjustment
        if adjustment.endswith("%"):
            adjusted = instance_type_price * (1 + float(adjustment[:-1]) / 100.0)
        else:
            adjusted = instance_type_price + float(adjustment)
        return adjusted if adjusted >= 0 else 0.0

    def validate(self) -> Optional[str]:
        """Runtime spec validation (nodeoverlay_validation.go + CEL rules)."""
        spec = self.spec
        if spec.price is not None and spec.price_adjustment is not None:
            return "cannot set both 'price' and 'priceAdjustment'"
        if spec.price is not None and not _PRICE_RE.match(spec.price):
            return f"invalid price {spec.price!r}"
        if spec.price_adjustment is not None and not _ADJUSTMENT_RE.match(
            spec.price_adjustment
        ):
            return f"invalid priceAdjustment {spec.price_adjustment!r}"
        if spec.weight and not (1 <= spec.weight <= 10_000):
            return "weight must be in [1, 10000]"
        for key in spec.capacity:
            if key in RESTRICTED_CAPACITY:
                return f"restricted capacity resource {key!r}"
        for req in spec.requirements:
            op = req.get("operator", "")
            values = req.get("values", []) or []
            if op in ("In", "NotIn") and not values:
                return f"requirement {req.get('key')!r} with operator {op!r} must have a value defined"
            if op in ("Gt", "Lt"):
                if len(values) != 1:
                    return f"operator {op!r} requires a single value"
                try:
                    if int(values[0]) < 0:
                        return f"operator {op!r} requires a non-negative integer"
                except ValueError:
                    return f"operator {op!r} requires an integer value"
        return None


def order_by_weight(overlays: Sequence[NodeOverlay]) -> list[NodeOverlay]:
    """nodeoverlay.go:93-105: larger weight first; equal weights order by
    name LATER in the alphabet first (consistent merge order)."""
    return sorted(
        overlays, key=lambda o: (-o.spec.weight, _Rev(o.metadata.name))
    )


class _Rev(str):
    def __lt__(self, other):  # reverse lexicographic
        return str.__gt__(self, other)


def _matches(reqs: Requirements, target: Requirements) -> bool:
    """Strict node-selector semantics over the target's defined labels: In /
    Exists / Gt / Lt fail on undefined keys; NotIn / DoesNotExist pass."""
    for r in reqs:
        if not target.has(r.key):
            # Requirements.get synthesizes Exists for undefined keys; a
            # selector on a label the target doesn't define must not match
            if r.operator in (Operator.IN, Operator.EXISTS, Operator.GT, Operator.LT):
                return False
            continue
        if not target.get(r.key).has_intersection(r):
            return False
    return True


class OverlayApplier:
    """Store-backed, memoized overlay application: adjusted catalogs are
    cached per (overlay versions, nodepool version, catalog identity) so
    downstream id-keyed caches (engine, domain groups) stay warm across
    passes, and the provisioner fetch and provider launch see the SAME
    adjusted prices."""

    def __init__(self, store):
        self.store = store
        self._cache: dict = {}

    def apply(self, node_pool, instance_types) -> list[InstanceType]:
        overlays = self.store.list(NodeOverlay.KIND)
        if not overlays or node_pool is None:
            return list(instance_types)
        key = (
            tuple(
                (o.metadata.uid, o.metadata.resource_version)
                for o in sorted(overlays, key=lambda o: o.metadata.name)
            ),
            node_pool.metadata.uid,
            node_pool.metadata.resource_version,
            tuple(map(id, instance_types)),
        )
        cached = self._cache.get(key)
        if cached is None:
            if len(self._cache) > 64:
                self._cache.clear()
            # hold the source types so their ids can't recycle while cached
            cached = (
                apply_overlays(overlays, node_pool, instance_types),
                list(instance_types),
            )
            self._cache[key] = cached
        return cached[0]


def apply_overlays(
    overlays: Sequence[NodeOverlay],
    node_pool,
    instance_types: Sequence[InstanceType],
) -> list[InstanceType]:
    """Overlay-adjusted copies of `instance_types` for one nodepool.

    Price: for each offering, the highest-weight overlay whose requirements
    match (instance-level labels from the type + nodepool template labels;
    offering-level keys match against the offering) sets the price.
    Capacity: extended resources merge from ALL matching overlays,
    higher-weight values winning per resource. Types nothing matches are
    returned as-is (no copies)."""
    valid = [o for o in overlays if o.validate() is None]
    if not valid:
        return list(instance_types)
    ordered = order_by_weight(valid)
    pool_labels = dict(node_pool.spec.template.labels)
    pool_labels[wk.NODEPOOL_LABEL_KEY] = node_pool.metadata.name
    pool_reqs = Requirements.from_labels(pool_labels)

    split = []
    for o in ordered:
        reqs = requirements_from_dicts(o.spec.requirements)
        inst_rows = Requirements(
            *(r for r in reqs if r.key not in _OFFERING_KEYS)
        )
        offer_rows = Requirements(*(r for r in reqs if r.key in _OFFERING_KEYS))
        split.append((o, inst_rows, offer_rows))

    out: list[InstanceType] = []
    for it in instance_types:
        target = Requirements(*it.requirements.values())
        target.add(*pool_reqs.values())
        matching = [
            (o, offer_rows)
            for o, inst_rows, offer_rows in split
            if _matches(inst_rows, target)
        ]
        if not matching:
            out.append(it)
            continue
        new_offerings = []
        changed = False
        for off in it.offerings:
            priced = None
            for o, offer_rows in matching:
                if offer_rows and not _matches(offer_rows, off.requirements):
                    continue
                if o.spec.price is not None or o.spec.price_adjustment is not None:
                    priced = o
                    break  # highest weight wins
            if priced is None:
                new_offerings.append(off)
                continue
            changed = True
            new_offerings.append(
                Offering(
                    requirements=off.requirements,
                    price=priced.adjusted_price(off.price),
                    available=off.available,
                    reservation_capacity=off.reservation_capacity,
                )
            )
        capacity = dict(it.capacity)
        for o, offer_rows in reversed(matching):  # low weight first: high overwrites
            if offer_rows:
                continue  # offering-scoped overlays don't add node capacity
            for key, value in o.spec.capacity.items():
                if key in RESTRICTED_CAPACITY:
                    continue
                capacity[key] = value
                changed = True
        if not changed:
            out.append(it)
            continue
        out.append(
            InstanceType(
                name=it.name,
                requirements=it.requirements,
                offerings=Offerings(new_offerings),
                capacity=capacity,
                overhead=it.overhead,
            )
        )
    return out
