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
way to test the shard math, not a serving feature (the scan's replicas on
a repeated device run one after the other). `build_solver_mesh` never
repeats a device.

On the card the sharded cube and group solve launch once per card, not
once per shard: `slab_plan` groups the shards by card, `stage_rows` moves
a card's entity rows there in one copy, the card's kernel covers all of
its shards, and `gather_cards` copies the other cards' rows to the first.
On CPU meshes each shard runs the plain versions on its own slab
(`split_rows`, `gather_rows`). `upload_rows` is the one-card case for
callers that want tensors back: the group solver's rows and the delta
frontier's rows and slots, each in one staged upload.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
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


class Replicas(tuple):
    """One copy of a tensor per shard of a mesh, as `replicate` and
    `per_shard` make it: copy s lies on shard s's device, and every copy is
    contiguous and of one dtype and shape. So a kernel wrapper that checks
    one copy's dtype and shape has checked them all, and an engine that
    caches the copies has them checked once, where it made them."""

    __slots__ = ()


def replicate(t: torch.Tensor, mesh: Mesh) -> Replicas:
    """One contiguous copy of `t` per shard: copied once per distinct
    device, the same tensor for shards on a repeated device (and `t` itself
    where it is already contiguous on that device)."""
    copies: dict = {}
    out = []
    for dev in mesh.devices:
        c = copies.get(dev)
        if c is None:
            c = copies[dev] = t.to(dev).contiguous()
        out.append(c)
    return Replicas(out)


def per_shard(x, mesh: Mesh) -> Replicas:
    """A replicated operand as one tensor per shard: `x` is either one
    tensor (replicated here) or already a per-shard tuple (an engine's
    cached copies), whose devices are checked against the mesh, and a
    plain tuple's dtypes, shapes and contiguity against each other."""
    if isinstance(x, tuple):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} replicas for a {mesh.size}-device mesh")
        for t, dev in zip(x, mesh.devices):
            if t.device != dev:
                raise ValueError(f"replica on {t.device}, its shard is on {dev}")
        if not isinstance(x, Replicas):
            first = x[0]
            for t in x:
                if t.dtype != first.dtype or t.shape != first.shape or not t.is_contiguous():
                    raise ValueError("replicas differ in dtype or shape, or are not contiguous")
            x = Replicas(x)
        return x
    return replicate(x, mesh)


def slab_plan(devices: Sequence, rows: int) -> list:
    """An axis of `rows` split into len(devices) equal contiguous slabs,
    slab s on devices[s], grouped by card: one (device, [(shard, lo, hi),
    ...]) per distinct device, in the order the devices first appear (the
    first is shard 0's, where results gather). Pure, for any device list,
    repeats included. The caller pads the axis to a multiple of the mesh
    size."""
    n = len(devices)
    if n == 0:
        raise ValueError("a slab plan needs at least one device")
    if rows % n:
        raise ValueError(f"axis of {rows} does not split over {n} devices")
    m = rows // n
    plan: dict = {}
    for s, dev in enumerate(devices):
        plan.setdefault(torch.device(dev), []).append((s, s * m, (s + 1) * m))
    return list(plan.items())


def card_runs(slabs: Sequence) -> list:
    """A card's shards (slab_plan's (shard, lo, hi), in shard order) as
    maximal runs of adjacent rows: (lo, hi, first row in the card's compact
    layout, which holds its shards' rows one after the other)."""
    runs: list = []
    at = 0
    for _, lo, hi in slabs:
        if runs and runs[-1][1] == lo:
            runs[-1][1] = hi
        else:
            runs.append([lo, hi, at])
        at += hi - lo
    return [tuple(r) for r in runs]


def staging_layout(tensors: Sequence[torch.Tensor], n: int) -> tuple:
    """Where `n` rows of each tensor go in a card's staging buffer: each
    tensor's rows one after the other, 16-byte aligned. Returns (offsets,
    total bytes)."""
    offsets, total = [], 0
    for t in tensors:
        offsets.append(total)
        total += -(-n * math.prod(t.shape[1:]) * t.element_size() // 16) * 16
    return offsets, total


def fill_staging(buf: np.ndarray, tensors: Sequence[torch.Tensor], runs: Sequence,
                 offsets: Sequence[int]) -> None:
    """Copy the rows of `runs` (card_runs') of each host tensor into the
    uint8 buffer `buf` at its offset, run after run: numpy slice copies,
    no torch op per run."""
    for t, off in zip(tensors, offsets):
        rows = t.numpy().reshape(t.shape[0], math.prod(t.shape[1:])).view(np.uint8)
        width = rows.shape[1]
        for lo, hi, c in runs:
            buf[off + c * width:off + (c + hi - lo) * width] = rows[lo:hi].reshape(-1)


def stage_rows(tensors: Sequence[torch.Tensor], slabs: Sequence, dev: torch.device) -> tuple:
    """One card's entity rows on that card, for a kernel that takes raw
    pointers: the rows of `slabs` (slab_plan's (shard, lo, hi) of the card)
    of every tensor of `tensors` (contiguous, on one device, the entity
    axis leading). Returns (a device pointer per tensor, each shard's first
    row there, the device memory to keep alive until the launch is queued,
    or None). Tensors already on `dev` are read in place: nothing moves,
    and a shard starts at its own lo. Host tensors go in one copy: the
    card's rows of all of them, shard after shard, into one pinned staging
    buffer, one non-blocking upload (_staged_upload). Tensors on another
    card go with one copy each."""
    if tensors[0].device == dev:
        return [t.data_ptr() for t in tensors], [lo for _, lo, _ in slabs], None
    runs = card_runs(slabs)
    n = sum(hi - lo for _, lo, hi in slabs)
    starts = [k * (n // len(slabs)) for k in range(len(slabs))]
    if tensors[0].device.type != "cpu":
        moved = [torch.cat([t[lo:hi] for lo, hi, _ in runs]).to(dev, non_blocking=True)
                 for t in tensors]
        return [t.data_ptr() for t in moved], starts, moved
    on_card, offsets = _staged_upload(tensors, runs, n, dev)
    base = on_card.data_ptr()
    return [base + off for off in offsets], starts, on_card


def _staged_upload(tensors: Sequence[torch.Tensor], runs: Sequence, n: int, dev: torch.device) -> tuple:
    """The rows of `runs` (card_runs') of every host tensor, `n` in all, in
    one pinned staging buffer (staging_layout, fill_staging) and one
    non-blocking upload to `dev`, so the host goes on while it travels:
    (the buffer on `dev`, each tensor's byte offset in it)."""
    offsets, total = staging_layout(tensors, n)
    staging = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    fill_staging(staging.numpy(), tensors, runs, offsets)
    return staging.to(dev, non_blocking=True), offsets


def upload_rows(arrays: Sequence[np.ndarray], dev: torch.device) -> tuple:
    """Host arrays sharing one leading row axis on `dev` in one copy: the
    one-card case of stage_rows that hands back tensors: one staged upload
    (_staged_upload), each returned tensor a view of its part of it
    (16-byte aligned). On a CPU device: the arrays as tensors, with no
    copy."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    if dev.type == "cpu":
        return tuple(tensors)
    n = tensors[0].shape[0]
    if any(t.shape[0] != n for t in tensors):
        raise ValueError(f"upload_rows: row counts differ {[t.shape[0] for t in tensors]}")
    on_card, offsets = _staged_upload(tensors, [(0, n, 0)], n, dev)
    return staged_views(on_card, tensors, offsets)


def staged_views(buf: torch.Tensor, tensors: Sequence[torch.Tensor], offsets: Sequence[int]) -> tuple:
    """Each tensor's rows in a uint8 staging buffer (or its upload), laid
    out by staging_layout for the tensors' full row counts, as a tensor of
    the tensor's dtype and shape: views, no copy."""
    return tuple(buf[off:off + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
                 for t, off in zip(tensors, offsets))


def gather_cards(out: torch.Tensor, parts: Sequence) -> None:
    """Copy every other card's rows into `out` (on the first card, which
    wrote its own rows there): `parts` holds (slabs, compact rows on that
    card) per card; one non-blocking copy per run of adjacent shards, so
    one per card when its shards are adjacent, as build_solver_mesh's
    are."""
    for slabs, part in parts:
        for lo, hi, c in card_runs(slabs):
            out[lo:hi].copy_(part[c:c + hi - lo], non_blocking=True)


def split_rows(t: torch.Tensor, mesh: Mesh) -> tuple:
    """`t`'s leading axis in n equal contiguous slabs, slab s on shard s's
    device (the CPU meshes' per-shard path). The caller pads the axis to a
    multiple of the mesh size."""
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
