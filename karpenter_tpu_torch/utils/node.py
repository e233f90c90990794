"""Node helpers (reference pkg/utils/node)."""

from __future__ import annotations

from typing import Any, Optional


def claim_for_node(store, node) -> Optional[Any]:
    """The NodeClaim owning a node, matched by provider id
    (pkg/utils/nodeclaim NodeClaimForNode) — the one lookup shared by the
    termination, health, GC, and hydration controllers."""
    pid = node.spec.provider_id
    if not pid:
        return None
    return next(
        iter(
            store.list(
                "NodeClaim",
                predicate=lambda c: c.status.provider_id == pid,
            )
        ),
        None,
    )
