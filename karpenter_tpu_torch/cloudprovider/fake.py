"""Scriptable fake CloudProvider for tests.

Mirrors the reference's pkg/cloudprovider/fake/cloudprovider.go:64-240 —
records Create/Delete calls, injects errors, serves per-nodepool instance
types, and fabricates hydrated NodeClaims with resolved labels.
"""

from __future__ import annotations

import copy
from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    NodeClaimNotFoundError,
    RepairPolicy,
    order_by_price,
)
from karpenter_tpu_torch.scheduling.requirements import requirements_from_dicts


class FakeCloudProvider(CloudProvider):
    def __init__(self, instance_types: Optional[list[InstanceType]] = None):
        self.instance_types = (
            instance_types if instance_types is not None else construct_instance_types()
        )
        self.instance_types_for_nodepool: dict[str, list[InstanceType]] = {}
        self.created: dict[str, NodeClaim] = {}  # provider id -> claim
        self.create_calls: list[NodeClaim] = []
        self.delete_calls: list[NodeClaim] = []
        self.next_create_err: Optional[Exception] = None
        self.next_get_err: Optional[Exception] = None
        self.next_delete_err: Optional[Exception] = None
        self.drifted: str = ""
        self._repair_policies: list[RepairPolicy] = []
        self._counter = 0

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        self.create_calls.append(node_claim)
        if self.next_create_err is not None:
            err, self.next_create_err = self.next_create_err, None
            raise err
        from karpenter_tpu_torch.utils import resources as res

        reqs = requirements_from_dicts(node_claim.spec.requirements)
        requests = node_claim.spec.resources.requests
        compatible = [
            it
            for it in self.get_instance_types_by_name(
                node_claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
            if it.requirements.intersects(reqs) is None
            and it.offerings.available().has_compatible(reqs)
            and res.fits(requests, it.allocatable())
        ]
        if not compatible:
            from karpenter_tpu_torch.cloudprovider.types import InsufficientCapacityError

            raise InsufficientCapacityError("no compatible instance types")
        it = order_by_price(compatible, reqs)[0]
        offering = next(
            o
            for o in it.offerings
            if o.available
            and reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
        )
        self._counter += 1
        created = copy.deepcopy(node_claim)
        created.status.provider_id = f"fake://{node_claim.metadata.name}-{self._counter}"
        created.status.capacity = dict(it.capacity)
        created.status.allocatable = dict(it.allocatable())
        # requirement-derived labels first; the chosen offering's zone and
        # capacity type must win (the node IS where it launched)
        created.metadata.labels.update(reqs.labels())
        created.metadata.labels.update(
            {
                wk.LABEL_INSTANCE_TYPE: it.name,
                wk.LABEL_TOPOLOGY_ZONE: offering.zone,
                wk.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type,
            }
        )
        created.status.image_id = "fake-image"
        self.created[created.status.provider_id] = created
        return created

    def delete(self, node_claim: NodeClaim) -> None:
        self.delete_calls.append(node_claim)
        if self.next_delete_err is not None:
            err, self.next_delete_err = self.next_delete_err, None
            raise err
        if node_claim.status.provider_id not in self.created:
            raise NodeClaimNotFoundError(node_claim.status.provider_id)
        del self.created[node_claim.status.provider_id]

    def get(self, provider_id: str) -> NodeClaim:
        if self.next_get_err is not None:
            err, self.next_get_err = self.next_get_err, None
            raise err
        claim = self.created.get(provider_id)
        if claim is None:
            raise NodeClaimNotFoundError(provider_id)
        return copy.deepcopy(claim)

    def list(self) -> list[NodeClaim]:
        return [copy.deepcopy(c) for c in self.created.values()]

    def get_instance_types(self, node_pool: NodePool) -> list[InstanceType]:
        return self.get_instance_types_by_name(node_pool.metadata.name)

    def get_instance_types_by_name(self, name: str) -> list[InstanceType]:
        return self.instance_types_for_nodepool.get(name, self.instance_types)

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return self.drifted

    def repair_policies(self) -> list[RepairPolicy]:
        return self._repair_policies

    def name(self) -> str:
        return "fake"

    def reset(self) -> None:
        self.__init__(self.instance_types)
