"""NodePool controllers: hash, counter, readiness, registration health,
validation.

Mirrors nodepool/{hash,counter,readiness,registrationhealth,validation}/
controller.go.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodepool import (
    CONDITION_NODECLASS_READY,
    CONDITION_NODE_REGISTRATION_HEALTHY,
    CONDITION_READY,
    CONDITION_VALIDATION_SUCCEEDED,
    NODEPOOL_HASH_VERSION,
    NodePool,
)
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils.clock import Clock


import re as _re

# CEL pattern for budget nodes (nodepool.go:99 kubebuilder marker):
# a plain non-negative integer or a 0-100 percent
_BUDGET_NODES_RE = _re.compile(r"^((100|[0-9]{1,2})%|[0-9]+)$")
# duration format: minutes/hours only — no seconds precision
# (nodepool.go:117 `^([0-9]+(m|h)+)+$`); runtime durations are parsed
# floats, so the equivalent check is whole-minute granularity
_LABEL_NAME_RE = _re.compile(r"^[A-Za-z0-9]([A-Za-z0-9_.\-]*[A-Za-z0-9])?$")
_LABEL_VALUE_RE = _re.compile(r"^([A-Za-z0-9]([A-Za-z0-9_.\-]*[A-Za-z0-9])?)?$")
_DNS_SUBDOMAIN_RE = _re.compile(
    r"^[a-z0-9]([a-z0-9\-]*[a-z0-9])?(\.[a-z0-9]([a-z0-9\-]*[a-z0-9])?)*$"
)
_VALID_TAINT_EFFECTS = frozenset({"NoSchedule", "PreferNoSchedule", "NoExecute"})
_VALID_OPERATORS = frozenset({"In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"})


def _validate_qualified_name(key: str) -> str | None:
    """k8s qualified-name rules: [dns-subdomain/]name, name 1-63 chars
    (validation the CRD enforces via CEL + apimachinery)."""
    if not key:
        return "key is required"
    if len(key) > 316:
        return f"key {key!r} exceeds the 316-character limit"
    if "/" in key:
        prefix, _, name = key.partition("/")
        if not prefix or len(prefix) > 253 or not _DNS_SUBDOMAIN_RE.match(prefix):
            return f"key {key!r} has an invalid prefix"
        if "/" in name:
            return f"key {key!r} has more than one prefix separator"
    else:
        name = key
    if len(name) > 63 or not _LABEL_NAME_RE.match(name):
        return f"key {key!r} is not a qualified name"
    return None


def _validate_budget(budget) -> str | None:
    if not _BUDGET_NODES_RE.match(budget.nodes):
        return f"invalid budget nodes value {budget.nodes!r}"
    if (budget.schedule is None) != (budget.duration is None):
        return "budget schedule and duration must be specified together"
    if budget.schedule is not None:
        from karpenter_tpu_torch.utils import cron

        err = cron.validate(budget.schedule)
        if err is not None:
            return f"invalid budget schedule {budget.schedule!r}: {err}"
    if budget.duration is not None:
        if budget.duration < 0:
            return "budget duration must not be negative"
        if budget.duration % 60 != 0:
            return "budget duration must not carry seconds precision"
    return None


def _validate_taint(taint) -> str | None:
    err = _validate_qualified_name(taint.key)
    if err is not None:
        return f"invalid taint key: {err}"
    if taint.value and not _LABEL_VALUE_RE.match(taint.value) or len(taint.value) > 63:
        return f"invalid taint value {taint.value!r}"
    if taint.effect and taint.effect not in _VALID_TAINT_EFFECTS:
        return f"invalid taint effect {taint.effect!r}"
    return None


def _validate_requirement(req: dict) -> str | None:
    key = req.get("key", "")
    err = _validate_qualified_name(key)
    if err is not None:
        return f"invalid requirement key: {err}"
    if key == wk.NODEPOOL_LABEL_KEY:
        return f"requirement key {key!r} is reserved"
    err = wk.is_restricted_label(key)
    if err is not None:
        return err
    op = req.get("operator", "")
    if op not in _VALID_OPERATORS:
        return f"unsupported requirement operator {op!r}"
    min_values = req.get("minValues")
    if min_values is not None:
        # requirements are untyped dicts: the validator must be total over
        # whatever shape arrives, never raise mid-reconcile
        if isinstance(min_values, bool) or not isinstance(min_values, int):
            return f"minValues must be an integer, got {min_values!r}"
        if not 1 <= min_values <= 50:
            return f"minValues must be in [1, 50], got {min_values}"
    return None


class HashController:
    """Maintains the static-field hash annotation driving drift
    (nodepool/hash/controller.go:46-124)."""

    def __init__(self, store: Store):
        self.store = store

    def reconcile(self, pool: NodePool) -> None:
        current = pool.static_hash()
        annotations = pool.metadata.annotations
        stored_version = annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY)
        if stored_version != NODEPOOL_HASH_VERSION:
            # hash-version migration: re-stamp the pool AND backfill claims so
            # they aren't spuriously drifted by the algorithm change
            for claim in self.store.list(
                "NodeClaim",
                predicate=lambda c: c.metadata.labels.get(wk.NODEPOOL_LABEL_KEY)
                == pool.metadata.name,
            ):
                # a claim already judged Drifted (either way) keeps its old
                # hash: the algorithm changed, so its drift verdict can't be
                # re-derived (hash/controller.go:108-114)
                if claim.get_condition("Drifted") is None:
                    claim.metadata.annotations[
                        wk.NODEPOOL_HASH_ANNOTATION_KEY
                    ] = current
                claim.metadata.annotations[
                    wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY
                ] = NODEPOOL_HASH_VERSION
                self.store.apply(claim)
        if (
            annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY) != current
            or stored_version != NODEPOOL_HASH_VERSION
        ):
            annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = current
            annotations[wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = NODEPOOL_HASH_VERSION
            self.store.apply(pool)


class CounterController:
    """Aggregates node+claim resources into nodepool status
    (nodepool/counter/controller.go:60-103)."""

    def __init__(self, store: Store, cluster: Cluster):
        self.store = store
        self.cluster = cluster

    def reconcile(self, pool: NodePool) -> None:
        resources = self.cluster.nodepool_resources_for(pool.metadata.name)
        node_count = int(resources.pop("nodes", 0.0))
        pool.status.resources = resources
        pool.status.node_count = node_count
        self.store.apply(pool)


class ReadinessController:
    """Ready condition from NodeClass readiness (readiness/controller.go:45-107).
    Without a NodeClass ref (kwok), the pool is Ready once validated."""

    def __init__(self, store: Store, clock: Clock):
        self.store = store
        self.clock = clock

    def reconcile(self, pool: NodePool) -> None:
        ref = pool.spec.template.spec.node_class_ref
        now = self.clock.now()
        if ref.kind:
            node_class = self.store.try_get(ref.kind, ref.name)
            if node_class is None:
                pool.set_condition(
                    CONDITION_NODECLASS_READY, "False",
                    reason="NodeClassNotFound", message="NodeClass not found", now=now,
                )
            else:
                status = "True"
                ready = getattr(node_class, "status", None)
                if ready is not None and getattr(ready, "conditions", None):
                    cond = next((c for c in ready.conditions if c.type == "Ready"), None)
                    if cond is not None and cond.status != "True":
                        status = "False"
                pool.set_condition(CONDITION_NODECLASS_READY, status, now=now)
        else:
            pool.set_condition(CONDITION_NODECLASS_READY, "True", now=now)
        ready = all(
            pool.condition_is_true(t)
            for t in (CONDITION_VALIDATION_SUCCEEDED, CONDITION_NODECLASS_READY)
        )
        pool.set_condition(CONDITION_READY, "True" if ready else "False", now=now)
        self.store.apply(pool)


class RegistrationHealthController:
    """Resets NodeRegistrationHealthy to Unknown on spec change
    (registrationhealth/controller.go:46-96)."""

    def __init__(self, store: Store, clock: Clock):
        self.store = store
        self.clock = clock
        self._seen_hashes: dict[str, str] = {}

    def reconcile(self, pool: NodePool) -> None:
        current = pool.static_hash()
        previous = self._seen_hashes.get(pool.metadata.name)
        self._seen_hashes[pool.metadata.name] = current
        if previous is not None and previous != current:
            pool.set_condition(
                CONDITION_NODE_REGISTRATION_HEALTHY, "Unknown",
                reason="NodePoolChanged", message="NodePool spec changed",
                now=self.clock.now(),
            )
            self.store.apply(pool)
        elif pool.get_condition(CONDITION_NODE_REGISTRATION_HEALTHY) is None:
            pool.set_condition(
                CONDITION_NODE_REGISTRATION_HEALTHY, "Unknown",
                reason="Initializing", message="", now=self.clock.now(),
            )
            self.store.apply(pool)


class ValidationController:
    """Runtime spec validation → ValidationSucceeded condition
    (validation/controller.go:44-82)."""

    def __init__(self, store: Store, clock: Clock):
        self.store = store
        self.clock = clock

    def reconcile(self, pool: NodePool) -> None:
        err = self._validate(pool)
        now = self.clock.now()
        if err is None:
            pool.set_condition(CONDITION_VALIDATION_SUCCEEDED, "True", now=now)
        else:
            pool.set_condition(
                CONDITION_VALIDATION_SUCCEEDED, "False",
                reason="ValidationFailed", message=err, now=now,
            )
        self.store.apply(pool)

    def _validate(self, pool: NodePool) -> str | None:
        """Runtime twin of the CRD's CEL validation rules
        (nodepool.go kubebuilder markers; nodepool_validation_cel_test.go)."""
        for budget in pool.spec.disruption.budgets:
            err = _validate_budget(budget)
            if err is not None:
                return err
        for taint in list(pool.spec.template.spec.taints) + list(
            pool.spec.template.spec.startup_taints
        ):
            err = _validate_taint(taint)
            if err is not None:
                return err
        for req in pool.spec.template.spec.requirements:
            err = _validate_requirement(req)
            if err is not None:
                return err
        for key in pool.spec.template.labels:
            err = wk.is_restricted_label(key)
            if err is not None:
                return err
        weight = pool.spec.weight
        if weight < 0 or weight > 100:
            return "weight must be in [0, 100]"
        return None
