"""In-flight NodeClaim simulation + the instance-type filter.

Mirrors the reference's scheduling/nodeclaim.go:37-441: CanAdd runs the gate
sequence taints → host ports → requirement compatibility → topology →
instance-type filter → reserved offerings; `filter_instance_types` is THE
hot kernel (nodeclaim.go:373-441) with the same three-criteria diagnostics.

The filter has two execution paths with identical semantics:
- host: per-type Python loop (the oracle; used for small catalogs)
- engine: batched CatalogEngine query on device (ops/catalog.py), selected
  when a `CatalogEngine` is attached and the catalog is large enough to pay
  for dispatch.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.cloudprovider.types import InstanceType, Offering
from karpenter_tpu_torch.ops import encoding as enc
from karpenter_tpu_torch.scheduler.nodeclaimtemplate import NodeClaimTemplate
from karpenter_tpu_torch.scheduler.reservationmanager import ReservationManager
from karpenter_tpu_torch.scheduler.topology import Topology
from karpenter_tpu_torch.scheduling.hostportusage import HostPortUsage, get_host_ports
from karpenter_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Operator,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.resources import ResourceList

RESERVED_OFFERING_MODE_FALLBACK = "Fallback"
RESERVED_OFFERING_MODE_STRICT = "Strict"

# Engine dispatch threshold: below this catalog size the Python loop beats
# device round-trips.
ENGINE_MIN_CATALOG = 64

_hostname_counter = itertools.count(1)


def raise_strict_reserved_errors(
    has_compatible: bool, reserved: Sequence, current_reserved: Sequence
) -> None:
    """Strict-mode reservation failures (nodeclaim.go:170-205) — the ONE
    source of these conditions and message strings, shared by the host's
    _offerings_to_reserve and the device solver's _reserved_eval so parity
    can't drift."""
    if has_compatible and not reserved:
        raise ReservedOfferingError(
            "one or more instance types with compatible reserved offerings "
            "are available, but could not be reserved"
        )
    if current_reserved and not reserved:
        raise ReservedOfferingError(
            "satisfying updated nodeclaim constraints would remove all "
            "compatible reserved offering options"
        )


class ReservedOfferingError(Exception):
    """Strict reserved-capacity failures that must not fall back
    (nodeclaim.go:51-67)."""


@dataclass
class InstanceTypeFilterError(Exception):
    """Which of compat/fits/offering failed across the whole catalog
    (nodeclaim.go:247-441)."""

    requirements_met: bool = False
    fits: bool = False
    has_offering: bool = False
    requirements_and_fits: bool = False
    requirements_and_offering: bool = False
    fits_and_offering: bool = False
    min_values_incompatible: Optional[str] = None

    def __str__(self) -> str:
        if self.min_values_incompatible is not None:
            return self.min_values_incompatible
        if not self.requirements_met and not self.fits and not self.has_offering:
            return (
                "no instance type met the scheduling requirements or had enough "
                "resources or had a required offering"
            )
        if not self.requirements_met and not self.fits:
            return "no instance type met the scheduling requirements or had enough resources"
        if not self.requirements_met and not self.has_offering:
            return "no instance type met the scheduling requirements or had a required offering"
        if not self.fits and not self.has_offering:
            return "no instance type had enough resources or had a required offering"
        if not self.requirements_met:
            return "no instance type met all requirements"
        if not self.fits:
            return "no instance type has enough resources"
        if not self.has_offering:
            return "no instance type has the required offering"
        if self.requirements_and_fits:
            return (
                "no instance type which met the scheduling requirements and had "
                "enough resources, had a required offering"
            )
        if self.fits_and_offering:
            return (
                "no instance type which had enough resources and the required "
                "offering met the scheduling requirements"
            )
        if self.requirements_and_offering:
            return (
                "no instance type which met the scheduling requirements and the "
                "required offering had the required resources"
            )
        return "no instance type met the requirements/resources/offering tuple"


def filter_instance_types(
    instance_types: Sequence[InstanceType],
    requirements: Requirements,
    total_requests: ResourceList,
    relax_min_values: bool = False,
    engine=None,
) -> tuple[list[InstanceType], dict[str, int], Optional[InstanceTypeFilterError]]:
    """The hot kernel (nodeclaim.go:373-441): keep types where
    compat ∧ fits ∧ has-offering; returns (remaining, unsatisfiable minValues
    keys, error-with-diagnostics)."""
    use_engine = (
        engine is not None
        and len(instance_types) >= ENGINE_MIN_CATALOG
        # resource names outside the engine's dims can't be encoded; the
        # host path keeps its structured diagnostics for them
        and all(k in engine.resource_dims for k in total_requests)
    )
    if use_engine:
        triples = _triples_engine(engine, instance_types, requirements, total_requests)
    else:
        triples = _triples_host(instance_types, requirements, total_requests)

    err = InstanceTypeFilterError()
    remaining: list[InstanceType] = []
    for it, (it_compat, it_fits, it_offering) in zip(instance_types, triples):
        err.requirements_met = err.requirements_met or it_compat
        err.fits = err.fits or it_fits
        err.has_offering = err.has_offering or it_offering
        err.requirements_and_fits = err.requirements_and_fits or (
            it_compat and it_fits and not it_offering
        )
        err.requirements_and_offering = err.requirements_and_offering or (
            it_compat and it_offering and not it_fits
        )
        err.fits_and_offering = err.fits_and_offering or (
            it_fits and it_offering and not it_compat
        )
        if it_compat and it_fits and it_offering:
            remaining.append(it)

    unsatisfiable: dict[str, int] = {}
    if requirements.has_min_values():
        from karpenter_tpu_torch.cloudprovider.types import satisfies_min_values

        _, unsatisfiable, min_err = satisfies_min_values(remaining, requirements)
        if min_err is not None:
            if not relax_min_values:
                err.min_values_incompatible = min_err
                remaining = []
            # relax: keep remaining, record relaxed keys via unsatisfiable
    if not remaining:
        from karpenter_tpu_torch.observability import explain as explmod

        rec = explmod.recorder()
        if rec.enabled and triples:
            # decode the per-type triple into first-failing-stage counts —
            # the host-path twin of the device sweep's stage plane, so the
            # elimination metric reads identically on either backend
            import numpy as np

            from karpenter_tpu_torch.ops import feasibility as feas

            t = np.asarray(triples, dtype=bool)
            rec.note_plane_counts(
                feas.stage_counts(feas.stage_plane_np(t[:, 0], t[:, 1], t[:, 2]))
            )
        return [], unsatisfiable, err
    return remaining, unsatisfiable, None


def _triples_host(instance_types, requirements, total_requests):
    out = []
    for it in instance_types:
        it_compat = it.requirements.intersects_ok(requirements)
        it_fits = res.fits(total_requests, it.allocatable())
        it_offering = any(
            o.available
            and requirements.is_compatible(
                o.requirements, allow_undefined=ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            )
            for o in it.offerings
        )
        out.append((it_compat, it_fits, it_offering))
    return out


def _triples_engine(engine, instance_types, requirements, total_requests):
    """Batched device path: one CatalogEngine query, then mask to the subset
    (engine rows cover the FULL catalog; `instance_types` is a narrowing)."""
    rows = engine.rows_for(requirements)
    req_vec = enc.encode_resource_lists(engine.resource_dims, [total_requests])
    f = engine.feasibility([rows], req_vec, engine.key_presence([requirements]))
    index = {id(it): i for i, it in enumerate(engine.instance_types)}
    out = []
    for it in instance_types:
        i = index.get(id(it))
        if i is None:  # type not in engine catalog (e.g. overlay copy) — host path
            out.extend(_triples_host([it], requirements, total_requests))
        else:
            out.append((bool(f.compat[0, i]), bool(f.fits[0, i]), bool(f.has_offering[0, i])))
    return out


class NodeClaim:
    """A NodeClaim being simulated (nodeclaim.go:37-245)."""

    def __init__(
        self,
        template: NodeClaimTemplate,
        topology: Topology,
        daemon_resources: ResourceList,
        daemon_hostports: HostPortUsage,
        instance_types: list[InstanceType],
        reservation_manager: ReservationManager,
        reserved_offering_mode: str = RESERVED_OFFERING_MODE_FALLBACK,
        reserved_capacity_enabled: bool = True,
        engine=None,
    ):
        self.template = template
        self.hostname = f"hostname-placeholder-{next(_hostname_counter):04d}"
        self.requirements = Requirements(*template.requirements.values())
        self.requirements.add(Requirement(wk.LABEL_HOSTNAME, Operator.IN, [self.hostname]))
        self.instance_type_options = list(instance_types)
        self.requests: ResourceList = dict(daemon_resources)
        self.daemon_resources = daemon_resources
        self.topology = topology
        self.hostport_usage = daemon_hostports
        self.reservation_manager = reservation_manager
        self.reserved_offering_mode = reserved_offering_mode
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self.reserved_offerings: list[Offering] = []
        self.engine = engine
        self.pods: list = []
        self.annotations = dict(template.annotations)
        self.labels = dict(template.labels)

    @classmethod
    def from_precomputed(
        cls,
        template: NodeClaimTemplate,
        topology: Topology,
        daemon_resources: ResourceList,
        daemon_hostports: HostPortUsage,
        instance_types: list[InstanceType],
        reservation_manager: ReservationManager,
        reserved_offering_mode: str,
        reserved_capacity_enabled: bool,
        engine,
        hostname: str,
        requirements: Requirements,
        pods: list,
        requests: ResourceList,
    ) -> "NodeClaim":
        """Construct from solver-precomputed state (the device fast path,
        ops/ffd.py emit): identical attribute set to __init__, but the
        requirement set, members, and accumulated requests are supplied
        instead of built — __init__'s template-requirements copy would be
        discarded work at hundreds of claims per solve."""
        nc = cls.__new__(cls)
        nc.template = template
        nc.hostname = hostname
        nc.requirements = requirements
        nc.instance_type_options = instance_types
        nc.requests = requests
        nc.daemon_resources = daemon_resources
        nc.topology = topology
        nc.hostport_usage = daemon_hostports
        nc.reservation_manager = reservation_manager
        nc.reserved_offering_mode = reserved_offering_mode
        nc.reserved_capacity_enabled = reserved_capacity_enabled
        nc.reserved_offerings = []
        nc.engine = engine
        nc.pods = pods
        nc.annotations = dict(template.annotations)
        nc.labels = dict(template.labels)
        return nc

    @property
    def nodepool_name(self) -> str:
        return self.template.nodepool_name

    def can_add(
        self, pod, pod_data, relax_min_values: bool = False
    ) -> tuple[Requirements, list[InstanceType], list[Offering]]:
        """Raises on infeasibility; returns (updated requirements, narrowed
        instance types, offerings to reserve)."""
        err = Taints(self.template.spec.taints).tolerates_pod(pod)
        if err is not None:
            raise ValueError(err)
        hostports = get_host_ports(pod)
        conflict = self.hostport_usage.conflicts(pod, hostports)
        if conflict is not None:
            raise ValueError(f"checking host port usage, {conflict}")

        nodeclaim_requirements = Requirements(*self.requirements.values())
        compat_err = nodeclaim_requirements.compatible(
            pod_data.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if compat_err is not None:
            raise ValueError(f"incompatible requirements, {compat_err}")
        nodeclaim_requirements.add(*pod_data.requirements.values())

        topology_requirements = self.topology.add_requirements(
            pod,
            self.template.spec.taints,
            pod_data.strict_requirements,
            nodeclaim_requirements,
            ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
        )
        topo_err = nodeclaim_requirements.compatible(
            topology_requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        )
        if topo_err is not None:
            raise ValueError(topo_err)
        nodeclaim_requirements.add(*topology_requirements.values())

        requests = res.merge(self.requests, pod_data.requests)
        remaining, unsatisfiable, filter_err = filter_instance_types(
            self.instance_type_options,
            nodeclaim_requirements,
            requests,
            relax_min_values,
            engine=self.engine,
        )
        if relax_min_values:
            for key, min_values in unsatisfiable.items():
                req = nodeclaim_requirements.get(key)
                req.min_values = min_values
        if filter_err is not None:
            raise filter_err
        offerings = self._offerings_to_reserve(remaining, nodeclaim_requirements)
        return nodeclaim_requirements, remaining, offerings

    def add(
        self,
        pod,
        pod_data,
        nodeclaim_requirements: Requirements,
        instance_types: list[InstanceType],
        offerings_to_reserve: list[Offering],
    ) -> None:
        self.pods.append(pod)
        self.instance_type_options = instance_types
        self.requests = res.merge(self.requests, pod_data.requests)
        self.requirements = nodeclaim_requirements
        self.topology.register(wk.LABEL_HOSTNAME, self.hostname)
        self.topology.record(
            pod,
            self.template.spec.taints,
            nodeclaim_requirements,
            ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
        )
        self.hostport_usage.add(pod, get_host_ports(pod))
        self.reservation_manager.reserve(self.hostname, *offerings_to_reserve)
        self._release_reserved_offerings(self.reserved_offerings, offerings_to_reserve)
        self.reserved_offerings = offerings_to_reserve

    def _release_reserved_offerings(self, current, updated) -> None:
        updated_ids = {o.reservation_id for o in updated}
        for o in current:
            if o.reservation_id not in updated_ids:
                self.reservation_manager.release(self.hostname, o)

    def _offerings_to_reserve(
        self, instance_types: list[InstanceType], requirements: Requirements
    ) -> list[Offering]:
        """Reserved offerings compatible with the claim, capacity permitting
        (nodeclaim.go:166-205)."""
        if not self.reserved_capacity_enabled:
            return []
        has_compatible = False
        reserved: list[Offering] = []
        for it in instance_types:
            # most catalogs carry no reserved offerings at all
            if not it.has_reserved_offerings:
                continue
            for o in it.offerings:
                if o.capacity_type != wk.CAPACITY_TYPE_RESERVED or not o.available:
                    continue
                if not requirements.is_compatible(
                    o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                ):
                    continue
                has_compatible = True
                if self.reservation_manager.can_reserve(self.hostname, o):
                    reserved.append(o)
        if self.reserved_offering_mode == RESERVED_OFFERING_MODE_STRICT:
            raise_strict_reserved_errors(
                has_compatible, reserved, self.reserved_offerings
            )
        return reserved

    def finalize_scheduling(self) -> None:
        """Strip the placeholder hostname; pin reserved capacity
        (nodeclaim.go:207-220)."""
        self.requirements = Requirements(
            *(r for r in self.requirements.values() if r.key != wk.LABEL_HOSTNAME)
        )
        if self.reserved_offerings:
            self.requirements = Requirements(
                *(
                    r
                    for r in self.requirements.values()
                    if r.key != wk.CAPACITY_TYPE_LABEL_KEY
                )
            )
            self.requirements.add(
                Requirement(
                    wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [wk.CAPACITY_TYPE_RESERVED]
                )
            )
            from karpenter_tpu_torch.cloudprovider.types import RESERVATION_ID_LABEL

            self.requirements.add(
                Requirement(
                    RESERVATION_ID_LABEL,
                    Operator.IN,
                    [o.reservation_id for o in self.reserved_offerings],
                )
            )

    def remove_instance_type_options_by_price_and_min_values(
        self, reqs: Requirements, max_price: float
    ) -> "NodeClaim":
        """Price gate for consolidation replacements (nodeclaim.go:222-231).
        Raises if the narrowed set violates minValues."""
        self.instance_type_options = [
            it
            for it in self.instance_type_options
            if _worst_launch_price(it, reqs) < max_price
        ]
        from karpenter_tpu_torch.cloudprovider.types import satisfies_min_values

        _, _, err = satisfies_min_values(self.instance_type_options, reqs)
        if err is not None:
            raise ValueError(err)
        return self

    def to_api_nodeclaim(self):
        """Template stamp with this claim's narrowed requirements/types and
        accumulated resource requests (daemon overhead + every added pod —
        the reference carries them on Spec.Resources, nodeclaim.go:98,172)."""
        template = self.template
        saved_reqs, saved_its = template.requirements, template.instance_type_options
        template.requirements = self.requirements
        template.instance_type_options = self.instance_type_options
        try:
            claim = template.to_node_claim()
            claim.metadata.annotations.update(self.annotations)
            claim.spec.resources.requests = dict(self.requests)
        finally:
            template.requirements, template.instance_type_options = saved_reqs, saved_its
        return claim


def _worst_launch_price(it: InstanceType, reqs: Requirements) -> float:
    from karpenter_tpu_torch.cloudprovider.types import Offerings

    return Offerings(it.offerings).available().worst_launch_price(reqs)
