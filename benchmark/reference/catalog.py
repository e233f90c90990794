"""The instance-type catalog a configuration states, as plain arrays.

The kwok generator (upstream kwok/tools/gen_instance_types.go:70-110):
for each cpu size, memory family (GiB per vCPU), os and arch, one type
`<family>-<cpu>x-<arch>-<os>` with one available offering per zone and
capacity type; capacity cpu, memory, pods; kube-reserved cpu and memory.
`repeat` > 1 appends copies named `<name>-r<k>` with the same labels,
offerings and capacity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.quantity import GIB


@dataclass
class Catalog:
    names: list          # [T] type names
    labels: list         # [T] {label key: frozenset of values} (the type's requirements)
    offerings: list      # [T] [(labels {key: value}, price, available)]
    capacity: np.ndarray  # [T, 3] cpu, memory, pods
    allocatable: np.ndarray  # [T, 3] capacity less kube-reserved

    def __len__(self) -> int:
        return len(self.names)


def kwok_catalog(spec: dict) -> Catalog:
    keys = spec["labels"]
    kube = spec["kube_reserved"]
    price = spec["price"]
    names, labels, offerings, cap, alloc = [], [], [], [], []
    for cpu in spec["cpu_sizes"]:
        for family, ratio in spec["families"].items():
            for os_name in spec["oses"]:
                for arch in spec["archs"]:
                    mem_gib = cpu * ratio
                    name = f"{family}-{cpu}x-{arch}-{os_name}"
                    names.append(name)
                    labels.append({
                        keys["instance_type"]: frozenset([name]),
                        keys["arch"]: frozenset([arch]),
                        keys["os"]: frozenset([os_name]),
                        keys["zone"]: frozenset(spec["zones"]),
                        keys["capacity_type"]: frozenset(spec["capacity_types"]),
                        keys["size"]: frozenset([f"{cpu}x"]),
                        keys["family"]: frozenset([family]),
                    })
                    offs = []
                    for zone in spec["zones"]:
                        for ct in spec["capacity_types"]:
                            p = price["per_cpu"] * cpu + price["per_gib"] * mem_gib
                            if ct == "spot":
                                p *= price["spot_factor"]
                            offs.append(({keys["capacity_type"]: ct, keys["zone"]: zone}, round(p, 6), True))
                    offerings.append(offs)
                    c = (float(cpu), mem_gib * GIB, float(spec["pods"]))
                    cap.append(c)
                    alloc.append((c[0] - kube["cpu"], c[1] - kube["memory_gib"] * GIB, c[2]))
    base = len(names)
    for r in range(1, spec.get("repeat", 1)):
        for i in range(base):
            names.append(f"{names[i]}-r{r}")
            labels.append(labels[i])
            offerings.append(offerings[i])
            cap.append(cap[i])
            alloc.append(alloc[i])
    return Catalog(names, labels, offerings, np.array(cap, dtype=np.float64),
                   np.array(alloc, dtype=np.float64))
