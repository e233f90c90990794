"""NodePool listing/ordering helpers (reference pkg/utils/nodepool)."""

from __future__ import annotations

from typing import Optional, Sequence

from karpenter_tpu_torch.apis.nodepool import CONDITION_READY, NodePool
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.utils.resources import ResourceList


def list_managed(store: Store, ready_only: bool = True) -> list[NodePool]:
    """Non-deleting (and optionally Ready) nodepools (provisioner.go:206-217)."""
    out = []
    for np in store.list("NodePool"):
        if np.metadata.deletion_timestamp is not None:
            continue
        if ready_only and not np.condition_is_true(CONDITION_READY):
            continue
        out.append(np)
    return out


def order_by_weight(node_pools: Sequence[NodePool]) -> list[NodePool]:
    """Descending weight, name tiebreak (nodepoolutils.OrderByWeight)."""
    return sorted(node_pools, key=lambda np: (-np.spec.weight, np.metadata.name))


def limits_exceeded_by(limits: ResourceList, usage: ResourceList) -> Optional[str]:
    """Error if usage exceeds any limit (v1.Limits.ExceededBy)."""
    for k, limit in limits.items():
        if usage.get(k, 0.0) > limit + 1e-9:
            return f"limit exceeded for resource {k}: used {usage.get(k, 0.0)}, limit {limit}"
    return None
