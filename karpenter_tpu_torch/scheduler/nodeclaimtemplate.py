"""NodeClaimTemplate: a NodePool's schedulable shape.

Mirrors the reference's scheduling/nodeclaimtemplate.go:38-105 — NodePool →
template with merged requirements; ToNodeClaim stamps labels, hash
annotations, owner refs, and truncates instance types to MaxInstanceTypes.
"""

from __future__ import annotations

import copy
from typing import Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import ObjectMeta, OwnerReference
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NODEPOOL_HASH_VERSION, NodePool
from karpenter_tpu_torch.cloudprovider.types import InstanceType, order_by_price
from karpenter_tpu_torch.scheduling.requirements import (
    Operator,
    Requirement,
    Requirements,
    requirements_from_dicts,
)

# Launch truncation constant (nodeclaimtemplate.go:40)
MAX_INSTANCE_TYPES = 60
# Runtime default for NodeClaim terminationGracePeriod (seconds) when the
# NodePool doesn't set one — nodeclaimtemplate.go:33-36
# (DefaultTerminationGracePeriod); None = no default.
DEFAULT_TERMINATION_GRACE_PERIOD: "float | None" = None


def node_class_label_key(group: str, kind: str) -> str:
    return f"{group}/{kind.lower()}".lstrip("/")


class NodeClaimTemplate:
    def __init__(self, node_pool: NodePool):
        self.nodepool_name = node_pool.metadata.name
        self.nodepool_uid = node_pool.metadata.uid
        self.nodepool_weight = node_pool.spec.weight
        self.spec = copy.deepcopy(node_pool.spec.template.spec)
        self.labels = dict(node_pool.spec.template.labels)
        self.annotations = dict(node_pool.spec.template.annotations)
        self.annotations[wk.NODEPOOL_HASH_ANNOTATION_KEY] = node_pool.static_hash()
        self.annotations[wk.NODEPOOL_HASH_VERSION_ANNOTATION_KEY] = NODEPOOL_HASH_VERSION
        self.labels[wk.NODEPOOL_LABEL_KEY] = self.nodepool_name
        ref = self.spec.node_class_ref
        if ref.kind:
            self.labels[node_class_label_key(ref.group, ref.kind)] = ref.name
        self.requirements = Requirements()
        self.requirements.add(*requirements_from_dicts(self.spec.requirements).values())
        self.requirements.add(*Requirements.from_labels(self.labels).values())
        self.instance_type_options: list[InstanceType] = []

    def to_node_claim(self) -> NodeClaim:
        """Stamp a launchable NodeClaim (nodeclaimtemplate.go:69-105)."""
        instance_types = order_by_price(self.instance_type_options, self.requirements)[
            :MAX_INSTANCE_TYPES
        ]
        existing = self.requirements.get(wk.LABEL_INSTANCE_TYPE)
        self.requirements.add(
            Requirement(
                wk.LABEL_INSTANCE_TYPE,
                Operator.IN,
                [it.name for it in instance_types],
                min_values=existing.min_values,
            )
        )
        claim = NodeClaim(
            metadata=ObjectMeta(
                name="",  # caller generates "<nodepool>-<n>"
                annotations=dict(self.annotations),
                labels=dict(self.labels),
                owner_references=[
                    OwnerReference(
                        kind="NodePool",
                        name=self.nodepool_name,
                        uid=self.nodepool_uid,
                        block_owner_deletion=True,
                    )
                ],
            ),
            spec=copy.deepcopy(self.spec),
        )
        claim.spec.requirements = self.requirements.node_selector_requirements()
        if claim.spec.termination_grace_period is None:
            # runtime defaulting (nodeclaimtemplate.go:33-36,102): a
            # process-level default applies when the NodePool doesn't set one
            claim.spec.termination_grace_period = DEFAULT_TERMINATION_GRACE_PERIOD
        return claim

    def __repr__(self) -> str:
        return f"NodeClaimTemplate({self.nodepool_name})"
