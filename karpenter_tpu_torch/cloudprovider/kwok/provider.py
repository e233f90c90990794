"""kwok CloudProvider: the in-tree correctness/benchmark harness.

Mirrors the reference's kwok/cloudprovider/cloudprovider.go:46-266 — Create
fabricates a Node object directly (no kubelet) after NodeRegistrationDelay;
a tick() stand-in for the kwok controller heartbeats fabricated nodes Ready.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Condition, Node, ObjectMeta, Taint
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
from karpenter_tpu_torch.cloudprovider.types import (
    CloudProvider,
    InstanceType,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    order_by_price,
)
from karpenter_tpu_torch.runtime.journal import IDEMPOTENCY_ANNOTATION
from karpenter_tpu_torch.runtime.store import AlreadyExists, Store
from karpenter_tpu_torch.scheduling.requirements import requirements_from_dicts
from karpenter_tpu_torch.scheduling.taints import UNREGISTERED_NO_EXECUTE_TAINT
from karpenter_tpu_torch.utils.clock import Clock

# Node appears this long after Create (kwok NodeRegistrationDelay)
NODE_REGISTRATION_DELAY = 2.0
# nodes are sharded into partitions for scale (cloudprovider.go:263-266)
PARTITION_LABEL = "kwok-partition"
NUM_PARTITIONS = 10


@dataclass
class _Instance:
    claim: NodeClaim
    instance_type: InstanceType
    node_due_at: float
    node_created: bool = False
    idempotency_key: str = ""


class KwokCloudProvider(CloudProvider):
    def __init__(self, store: Store, clock: Clock,
                 instance_types: Optional[list[InstanceType]] = None,
                 registration_delay: float = NODE_REGISTRATION_DELAY):
        self.store = store
        self.clock = clock
        self.instance_types = (
            instance_types if instance_types is not None else construct_instance_types()
        )
        self.registration_delay = registration_delay
        self._instances: dict[str, _Instance] = {}
        self._counter = 0
        # launch idempotency: key (claim annotation, runtime/journal.py) ->
        # provider id, so a retried or crash-replayed create returns the
        # instance it already acknowledged instead of launching twice
        self._keys: dict[str, str] = {}
        # key -> actual materializations, kept across deletes; any key with
        # more than one launch is a double-launch (the sim's crash sweep
        # asserts this stays zero)
        self._key_launches: dict[str, int] = {}
        self.idempotent_hits = 0
        # NodeOverlay application at launch (the provider-side half: the
        # operator wraps get_instance_types consumers with the same overlays,
        # so launch picks by the SAME adjusted prices the scheduler saw).
        # Fail-safe off; the operator enables it from the feature gate.
        self.honor_overlays = False
        from karpenter_tpu_torch.apis.nodeoverlay import OverlayApplier

        self._overlay_applier = OverlayApplier(store)

    # -- CloudProvider boundary ---------------------------------------------

    def create(self, node_claim: NodeClaim) -> NodeClaim:
        # key-idempotent create: the same idempotency key returns the
        # existing acknowledged instance — an ambiguous failure (ack lost
        # to a crash or a raised error) retried with the same key cannot
        # materialize a second node for one NodeClaim
        key = node_claim.metadata.annotations.get(IDEMPOTENCY_ANNOTATION, "")
        if key:
            existing = self._keys.get(key)
            if existing is not None and existing in self._instances:
                self.idempotent_hits += 1
                return copy.deepcopy(self._instances[existing].claim)
        reqs = requirements_from_dicts(node_claim.spec.requirements)
        from karpenter_tpu_torch.utils import resources as res

        catalog = self.instance_types
        if self.honor_overlays:
            pool = self.store.try_get(
                "NodePool", node_claim.metadata.labels.get(wk.NODEPOOL_LABEL_KEY, "")
            )
            catalog = self._overlay_applier.apply(pool, catalog)
        requests = node_claim.spec.resources.requests
        compatible = [
            it
            for it in catalog
            if it.requirements.intersects(reqs) is None
            and it.offerings.available().has_compatible(reqs)
            and res.fits(requests, it.allocatable())
        ]
        if not compatible:
            raise InsufficientCapacityError(
                "no compatible instance types for nodeclaim requirements"
            )
        it = order_by_price(compatible, reqs)[0]
        offering = next(
            o
            for o in sorted(it.offerings, key=lambda o: o.price)
            if o.available
            and reqs.is_compatible(o.requirements, allow_undefined=wk.WELL_KNOWN_LABELS)
        )
        self._counter += 1
        created = copy.deepcopy(node_claim)
        created.status.provider_id = f"kwok://{node_claim.metadata.name}-{self._counter}"
        created.status.capacity = dict(it.capacity)
        created.status.allocatable = dict(it.allocatable())
        created.status.image_id = "kwok-ami"
        # Stamp every single-valued In requirement from the claim, the chosen
        # instance type, and the offering as node labels — the reference does
        # this directly, bypassing restricted-label filtering, so nodes carry
        # arch/os/zone labels (kwok/cloudprovider/cloudprovider.go:235-266).
        for source in (reqs, it.requirements, offering.requirements):
            for r in source:
                if r.operator == "In" and len(r) == 1:
                    created.metadata.labels[r.key] = r.values_list()[0]
        created.metadata.labels.update(
            {
                wk.LABEL_INSTANCE_TYPE: it.name,
                wk.LABEL_TOPOLOGY_ZONE: offering.zone,
                wk.CAPACITY_TYPE_LABEL_KEY: offering.capacity_type,
                PARTITION_LABEL: f"partition-{self._counter % NUM_PARTITIONS}",
            }
        )
        self._instances[created.status.provider_id] = _Instance(
            claim=created,
            instance_type=it,
            node_due_at=self.clock.now() + self.registration_delay,
            idempotency_key=key,
        )
        if key:
            self._keys[key] = created.status.provider_id
            self._key_launches[key] = self._key_launches.get(key, 0) + 1
        return created

    def double_launches(self) -> int:
        """Keys that materialized more than one instance — the crash-sweep
        invariant (zero, always)."""
        return sum(n - 1 for n in self._key_launches.values() if n > 1)

    def delete(self, node_claim: NodeClaim) -> None:
        pid = node_claim.status.provider_id
        if pid not in self._instances:
            raise NodeClaimNotFoundError(pid)
        inst = self._instances.pop(pid)
        if inst.idempotency_key:
            self._keys.pop(inst.idempotency_key, None)

    def get(self, provider_id: str) -> NodeClaim:
        inst = self._instances.get(provider_id)
        if inst is None:
            raise NodeClaimNotFoundError(provider_id)
        return copy.deepcopy(inst.claim)

    def list(self) -> list[NodeClaim]:
        return [copy.deepcopy(i.claim) for i in self._instances.values()]

    def get_instance_types(self, node_pool: NodePool) -> list[InstanceType]:
        return list(self.instance_types)

    def is_drifted(self, node_claim: NodeClaim) -> str:
        return ""

    def name(self) -> str:
        return "kwok"

    def reclaim(self, provider_id: str) -> bool:
        """Out-of-band capacity reclaim (a spot interruption the control
        plane never consented to): the instance vanishes without a Delete
        call, the way a real cloud takes spot capacity back. Subsequent
        get() raises NodeClaimNotFoundError and the GC controller reaps the
        claim. Returns whether the instance existed."""
        inst = self._instances.pop(provider_id, None)
        if inst is not None and inst.idempotency_key:
            self._keys.pop(inst.idempotency_key, None)
        return inst is not None

    # -- the fake kubelet (kwok controller) ---------------------------------

    def tick(self) -> int:
        """Fabricate due Nodes and heartbeat existing ones Ready
        (cloudprovider.go:58-86, 185-233). Returns nodes fabricated."""
        fabricated = 0
        now = self.clock.now()
        for inst in self._instances.values():
            if inst.node_created or now < inst.node_due_at:
                continue
            claim = inst.claim
            node = Node(
                metadata=ObjectMeta(
                    name=claim.metadata.name,
                    labels=dict(claim.metadata.labels),
                    annotations=dict(claim.metadata.annotations),
                ),
            )
            node.metadata.labels[wk.LABEL_HOSTNAME] = node.metadata.name
            node.spec.provider_id = claim.status.provider_id
            node.spec.taints = list(claim.spec.taints) + list(
                claim.spec.startup_taints
            ) + [UNREGISTERED_NO_EXECUTE_TAINT]
            node.status.capacity = dict(claim.status.capacity)
            node.status.allocatable = dict(claim.status.allocatable)
            node.status.conditions.append(
                Condition(type="Ready", status="True", reason="KubeletReady")
            )
            try:
                self.store.create(node)
            except AlreadyExists:
                pass
            inst.node_created = True
            fabricated += 1
        return fabricated
