"""The solver mesh: the pod axis of the sharded solves split over devices.

The counterpart of the reference's `jax.sharding.Mesh` over a `"pods"`
axis, of `aot/ladder.MESH_ALIGN` / `mesh_multiple` (kept here: the port
has no `aot/`), and of the Provisioner's `_build_solver_mesh`. The
reference's sharded programs hold no collective: the cube and the group
solve split their entity axis and replicate the catalog, the scan is
replicated whole, and results are gathered at emit. So the mesh is one
process that launches each shard's kernels on that shard's device (each
kernel wrapper makes its operands' device current and launches on that
device's current stream, device.launch); no process group.

A `Mesh` may repeat one device (`Mesh([torch.device("cpu")] * 8)` in the
tests, `cuda:0` twice on a one-card machine): the counterpart of the
reference's `--xla_force_host_platform_device_count` virtual devices, a
way to test the shard math, not a serving feature. Shards on a repeated
device run one after the other. `build_solver_mesh` never repeats a
device.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.operator import logging as klog

_log = klog.logger("solver-mesh")

# Sharded dispatches align their entity axis to a multiple of lcm(mesh size,
# MESH_ALIGN), so the padded GLOBAL shape is the same for every mesh size
# dividing MESH_ALIGN: the mesh changes how a shape splits across devices,
# never which shape is solved (the reference's aot/ladder.py).
MESH_ALIGN = 8


def mesh_multiple(n: int) -> int:
    """The entity-axis alignment for an n-device mesh: lcm(n, MESH_ALIGN)."""
    return (n * MESH_ALIGN) // math.gcd(max(1, n), MESH_ALIGN)


class Mesh:
    """An ordered list of torch devices on one named axis."""

    def __init__(self, devices: Sequence, axis_names: tuple = ("pods",)):
        if len(axis_names) != 1:
            raise ValueError(f"a solver mesh has one axis, got {axis_names}")
        self.devices = tuple(resolve_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError(f"a mesh's devices must be of one type: {self.devices}")
        self.axis_names = tuple(axis_names)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis_names={self.axis_names})"


def build_solver_mesh(n: int):
    """A Mesh over `cuda:0..n-1` for the sharded solves (the reference's
    `_build_solver_mesh`); None when off (n < 1) or when the machine has
    fewer than n CUDA devices, with a warning: the solve then runs
    unsharded, still on the card. A 1-device mesh is real: it routes the
    sharded solves and decides as the unsharded path does. Logs the mesh
    shape and device names once per build."""
    if n < 1:
        return None
    available = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if available < n:
        _log.warning(
            "not enough devices for the requested solver mesh; running single-device",
            shard_devices=n,
            available=available,
        )
        return None
    mesh = Mesh([torch.device("cuda", i) for i in range(n)])
    _log.info(
        "solver mesh built: pod axis sharded over local devices",
        shard_devices=n,
        mesh_shape=mesh.shape,
        device_names=sorted({torch.cuda.get_device_name(d) for d in mesh.devices}),
    )
    return mesh


def replicate(t: torch.Tensor, mesh: Mesh) -> tuple:
    """One copy of `t` per shard: copied once per distinct device, the same
    tensor for shards on a repeated device (and `t` itself on its own)."""
    copies: dict = {}
    out = []
    for dev in mesh.devices:
        c = copies.get(dev)
        if c is None:
            c = copies[dev] = t.to(dev)
        out.append(c)
    return tuple(out)


def per_shard(x, mesh: Mesh) -> tuple:
    """A replicated operand as one tensor per shard: `x` is either one
    tensor (replicated here) or already a per-shard tuple (an engine's
    cached copies)."""
    if isinstance(x, tuple):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} replicas for a {mesh.size}-device mesh")
        for t, dev in zip(x, mesh.devices):
            if t.device != dev:
                raise ValueError(f"replica on {t.device}, its shard is on {dev}")
        return x
    return replicate(x, mesh)


def split_rows(t: torch.Tensor, mesh: Mesh) -> tuple:
    """`t`'s leading axis in n equal contiguous slabs, slab s on shard s's
    device. The caller pads the axis to a multiple of the mesh size."""
    n = mesh.size
    if t.shape[0] % n:
        raise ValueError(f"axis of {t.shape[0]} does not split over {n} devices")
    m = t.shape[0] // n
    out = []
    for s, dev in enumerate(mesh.devices):
        out.append(t[s * m:(s + 1) * m].to(dev))
    return tuple(out)


def gather_rows(parts: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' results concatenated in shard order on the first
    shard's device."""
    dev = mesh.devices[0]
    return torch.cat([p.to(dev) for p in parts])
