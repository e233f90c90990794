"""Generated kwok instance catalog.

Mirrors the reference's generated catalog shape (kwok/tools/
gen_instance_types.go:70-110): 12 CPU sizes × 3 memory ratios × 2 OS ×
2 arch = 144 types, each with 8 offerings (4 zones × {spot, on-demand});
price = 0.025·cpu + 0.001·GiB, spot = 0.7×.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.cloudprovider.types import (
    InstanceType,
    InstanceTypeOverhead,
    Offering,
    Offerings,
)
from karpenter_tpu_torch.scheduling.requirements import Operator, Requirement, Requirements

CPU_SIZES = [1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256]
MEM_RATIOS = {"c": 2, "s": 4, "m": 8}  # GiB per vCPU
OSES = ["linux", "windows"]
ARCHS = [wk.ARCHITECTURE_AMD64, wk.ARCHITECTURE_ARM64]
ZONES = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
CAPACITY_TYPES = [wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND]

GIB = float(2**30)

INSTANCE_TYPE_GROUP_LABEL = "karpenter.kwok.sh/instance-group"
INSTANCE_SIZE_LABEL = "karpenter.kwok.sh/instance-size"
INSTANCE_FAMILY_LABEL = "karpenter.kwok.sh/instance-family"


def price_of(cpu: float, mem_gib: float, capacity_type: str) -> float:
    price = 0.025 * cpu + 0.001 * mem_gib
    if capacity_type == wk.CAPACITY_TYPE_SPOT:
        price *= 0.7
    return round(price, 6)


def construct_instance_types() -> list[InstanceType]:
    """Memoized: every caller shares the same InstanceType objects, so the
    provisioner's id-keyed CatalogEngine cache hits across provider
    instances (one device encode + compile per process). The returned list
    is a fresh copy; the elements are shared and must not be mutated."""
    return list(_construct_instance_types_cached())


def _construct_instance_types_cached() -> tuple[InstanceType, ...]:
    global _CATALOG
    if _CATALOG is None:
        _CATALOG = tuple(_build_instance_types())
    return _CATALOG


_CATALOG = None


def _build_instance_types() -> list[InstanceType]:
    out: list[InstanceType] = []
    for cpu in CPU_SIZES:
        for family, ratio in MEM_RATIOS.items():
            for os_name in OSES:
                for arch in ARCHS:
                    mem_gib = cpu * ratio
                    name = f"{family}-{cpu}x-{arch}-{os_name}"
                    reqs = Requirements(
                        Requirement(wk.LABEL_INSTANCE_TYPE, Operator.IN, [name]),
                        Requirement(wk.LABEL_ARCH, Operator.IN, [arch]),
                        Requirement(wk.LABEL_OS, Operator.IN, [os_name]),
                        Requirement(wk.LABEL_TOPOLOGY_ZONE, Operator.IN, ZONES),
                        Requirement(
                            wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, CAPACITY_TYPES
                        ),
                        Requirement(INSTANCE_SIZE_LABEL, Operator.IN, [f"{cpu}x"]),
                        Requirement(INSTANCE_FAMILY_LABEL, Operator.IN, [family]),
                    )
                    offerings = Offerings(
                        Offering(
                            requirements=Requirements(
                                Requirement(
                                    wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, [ct]
                                ),
                                Requirement(wk.LABEL_TOPOLOGY_ZONE, Operator.IN, [zone]),
                            ),
                            price=price_of(cpu, mem_gib, ct),
                            available=True,
                        )
                        for zone in ZONES
                        for ct in CAPACITY_TYPES
                    )
                    capacity = {
                        wk.RESOURCE_CPU: float(cpu),
                        wk.RESOURCE_MEMORY: mem_gib * GIB,
                        wk.RESOURCE_PODS: 110.0,
                        wk.RESOURCE_EPHEMERAL_STORAGE: 20.0 * GIB,
                    }
                    overhead = InstanceTypeOverhead(
                        kube_reserved={
                            wk.RESOURCE_CPU: 0.100,
                            wk.RESOURCE_MEMORY: 0.2 * GIB,
                        }
                    )
                    out.append(
                        InstanceType(
                            name=name,
                            requirements=reqs,
                            offerings=offerings,
                            capacity=capacity,
                            overhead=overhead,
                        )
                    )
    return out
