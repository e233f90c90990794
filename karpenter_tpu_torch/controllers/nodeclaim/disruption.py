"""NodeClaim disruption conditions: Drifted detection + Consolidatable.

Mirrors the reference's nodeclaim/disruption/{controller,drift,
consolidation}.go.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import (
    CONDITION_CONSOLIDATABLE,
    CONDITION_DRIFTED,
    CONDITION_INITIALIZED,
    CONDITION_LAUNCHED,
    NodeClaim,
)
from karpenter_tpu_torch.apis.nodepool import NODEPOOL_HASH_VERSION, NodePool
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, Offerings
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduling.requirements import (
    Operator,
    Requirement,
    Requirements,
    requirements_from_dicts,
)
from karpenter_tpu_torch.utils.clock import Clock

DRIFT_RECHECK_PERIOD = 300.0  # drift re-evaluated every 5m

NODEPOOL_DRIFTED = "NodePoolDrifted"
REQUIREMENTS_DRIFTED = "RequirementsDrifted"
INSTANCE_TYPE_NOT_FOUND = "InstanceTypeNotFound"


class DisruptionController:
    def __init__(self, store: Store, cloud_provider: CloudProvider, clock: Clock):
        self.store = store
        self.cloud_provider = cloud_provider
        self.clock = clock

    def reconcile(self, claim: NodeClaim) -> None:
        if claim.metadata.deletion_timestamp is not None:
            return
        pool = self.store.try_get(
            "NodePool", claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
        )
        if pool is None:
            return
        self._reconcile_drift(pool, claim)
        self._reconcile_consolidatable(pool, claim)
        self.store.apply(claim)

    # -- drift (drift.go:50-110) --------------------------------------------

    def _reconcile_drift(self, pool: NodePool, claim: NodeClaim) -> None:
        if not claim.condition_is_true(CONDITION_LAUNCHED):
            claim.clear_condition(CONDITION_DRIFTED)
            return
        reason = self.is_drifted(pool, claim)
        if not reason:
            claim.clear_condition(CONDITION_DRIFTED)
            return
        claim.set_condition(
            CONDITION_DRIFTED, "True", reason=reason, message=reason,
            now=self.clock.now(),
        )

    def is_drifted(self, pool: NodePool, claim: NodeClaim) -> str:
        reason = _static_fields_drifted(pool, claim) or _requirements_drifted(pool, claim)
        if reason:
            return reason
        reason = self._instance_type_not_found(pool, claim)
        if reason:
            return reason
        return self.cloud_provider.is_drifted(claim)

    def _instance_type_not_found(self, pool: NodePool, claim: NodeClaim) -> str:
        """Offerings are compared WITHOUT an availability filter — temporary
        unavailability is not drift (drift.go:112-144)."""
        its = self.cloud_provider.get_instance_types(pool)
        name = claim.metadata.labels.get(wk.LABEL_INSTANCE_TYPE, "")
        it = next((i for i in its if i.name == name), None)
        if it is None:
            return INSTANCE_TYPE_NOT_FOUND
        reqs = Requirements.from_labels(claim.metadata.labels)
        # a reserved claim can be demoted to on-demand after creation; accept
        # either so a stale capacity-type label doesn't drift the claim
        # (drift.go:131-139) — requirement drift (checked first in
        # is_drifted) catches real nodepool mismatches
        if (
            claim.metadata.labels.get(wk.CAPACITY_TYPE_LABEL_KEY)
            == wk.CAPACITY_TYPE_RESERVED
        ):
            reqs = Requirements(
                *(
                    r
                    for r in reqs.values()
                    if r.key
                    not in (wk.CAPACITY_TYPE_LABEL_KEY, wk.RESERVATION_ID_LABEL_KEY)
                )
            )
            reqs.add(
                Requirement(
                    wk.CAPACITY_TYPE_LABEL_KEY,
                    Operator.IN,
                    [wk.CAPACITY_TYPE_RESERVED, wk.CAPACITY_TYPE_ON_DEMAND],
                )
            )
        if not Offerings(it.offerings).has_compatible(reqs):
            return INSTANCE_TYPE_NOT_FOUND
        return ""

    # -- consolidatable (consolidation.go:36-72) ----------------------------

    def _reconcile_consolidatable(self, pool: NodePool, claim: NodeClaim) -> None:
        consolidate_after = pool.spec.disruption.consolidate_after
        if consolidate_after is None:
            claim.clear_condition(CONDITION_CONSOLIDATABLE)
            return
        initialized = claim.get_condition(CONDITION_INITIALIZED)
        if initialized is None or initialized.status != "True":
            claim.clear_condition(CONDITION_CONSOLIDATABLE)
            return
        reference_time = (
            claim.status.last_pod_event_time
            if claim.status.last_pod_event_time
            else initialized.last_transition_time
        )
        if self.clock.now() - reference_time < consolidate_after:
            claim.clear_condition(CONDITION_CONSOLIDATABLE)
            return
        claim.set_condition(CONDITION_CONSOLIDATABLE, "True", now=self.clock.now())


def _static_fields_drifted(pool: NodePool, claim: NodeClaim) -> str:
    """Hash-annotation comparison, skipped across hash-version migrations
    (drift.go:112-135)."""
    pool_hash = pool.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
    pool_version = pool.metadata.annotations.get(wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY)
    claim_hash = claim.metadata.annotations.get(wk.NODEPOOL_HASH_ANNOTATION_KEY)
    claim_version = claim.metadata.annotations.get(
        wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY
    )
    if pool_hash is None or claim_hash is None:
        return ""
    if pool_version != claim_version:
        return ""
    return NODEPOOL_DRIFTED if pool_hash != claim_hash else ""


def _requirements_drifted(pool: NodePool, claim: NodeClaim) -> str:
    """Claim labels no longer satisfy the nodepool's requirements — the
    claim's label set is the base, the pool's requirements the incoming
    constraint (drift.go:137-150)."""
    pool_reqs = Requirements()
    pool_reqs.add(
        *requirements_from_dicts(pool.spec.template.spec.requirements).values()
    )
    pool_reqs.add(*Requirements.from_labels(pool.spec.template.labels).values())
    claim_labels = Requirements.from_labels(claim.metadata.labels)
    if claim_labels.compatible(pool_reqs, wk.WELL_KNOWN_LABELS) is not None:
        return REQUIREMENTS_DRIFTED
    return ""
