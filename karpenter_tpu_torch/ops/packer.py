"""The group solver and the fused FFD scan (the one-dispatch solve) on the card.

Two device solvers, each a port of the reference's
karpenter_tpu/ops/packer.py, with a hand-written kernel per JAX program:

1. **The group solver** (`GroupSolver`): pods deduplicated into groups by
   (requirement rows, quantized requests); one device pass computes the
   feasibility cube compat ∧ fits ∧ offering over [G groups × I types],
   picks each group's cheapest feasible type and its per-group node count
   by integer packing math. `solve_block` (B9, the reference's
   `solve_block_jit`) and `solve_block_core` (B10) each launch
   kt_group_solve (csrc/packer.cu) once: the whole per-group solve, the
   cube's halves included, in its finalize and core modes. A delta pass
   with a frontier (ops/delta.py) runs `delta_pass`, the kernel's pass
   mode: the frontier's core rows go straight into the resident core
   matrix at their slots, and the launch's last block gathers and
   finalizes the pass's rows: B10, `delta_scatter_rows` (B11) and
   `delta_finalize` (B12) in one launch. `solve_block_scatter` is the
   scatter mode alone (B10 + B11); B11's and B12's own kernels serve their
   standalone wrappers, B12's a pass without a frontier. With a mesh,
   `solve_sharded` runs `sharded_solve_block` (B13): equal group slabs, the
   catalog replicated, one kt_group_solve launch per card for the whole
   per-group solve of its shards, the rows gathered.

2. **The fused scan**: the monotone FFD scan itself — the host walk's
   queue, emptiest-first claim heap, existing-node scan pointers, claim
   opening and nodepool-limit tracking — as ONE launch of kt_solve_scan
   (csrc/scan.cu) over the count tensors, requirement-family transition
   tables and per-claim headroom matrices ops/fused.py builds. Three
   variants share the kernel and the plain loop: `solve_scan` (B14,
   `solve_scan_fn`: the reference's 10 outputs), `solve_scan_full` (B15,
   the full loop state, the delta residency's seed) and `solve_scan_resume`
   (B16: continues a resident state with a suffix of new pods, writing the
   state tensors in place where the reference donates them). Their mesh
   twins (`sharded_solve_scan{,_full,_resume}`, B17) replicate: every
   shard runs the same launch on its own copy and shard 0's result is
   taken.

Decision parity is bit-for-bit: every float comparison of the scan runs in
float64, subtractions happen per join in the host's exact order, and claim
selection reproduces the host heap's (count, rank, claim-index) order as an
argmin over a packed int64 key; the group solver is integer and bool math
plus a float32 argmin with the first index winning ties.

Every public solve function is a wrapper: given CUDA tensors it checks them
and launches its kernel, given CPU tensors it runs the `*_plain` version
beside it, written from the reference program. `LAUNCHES` counts kernel
launches only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from karpenter_tpu_torch import mesh as mesh_mod
from karpenter_tpu_torch.convert import SCAN_OPERANDS
from karpenter_tpu_torch.device import KernelError, device_work, kernel_library, launch
from karpenter_tpu_torch.ops import feasibility as feas
from karpenter_tpu_torch.ops.catalog import CatalogEngine
from karpenter_tpu_torch.ops.feasibility import uid_project_plain
from karpenter_tpu_torch.scheduling.requirements import Requirements
from karpenter_tpu_torch.tracing import kernel as ktime

LAUNCHES: dict[str, int] = {
    "solve_scan": 0, "solve_scan_full": 0, "solve_scan_resume": 0,
    # every kt_solve_scan launch again, by the design it took (beside the
    # totals above, which count them by variant)
    "scan_resident": 0, "scan_global": 0,
    "solve_block": 0, "solve_block_core": 0, "solve_block_scatter": 0, "delta_scatter": 0,
    "delta_finalize": 0, "delta_pass": 0,
    "sharded_solve_block": 0, "sharded_solve_scan": 0, "sharded_solve_scan_full": 0,
    "sharded_solve_scan_resume": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_check, _on_cpu, _ptr = feas._check, feas._on_cpu, feas._ptr


# == the group solver ==========================================================

INF_PRICE = 3.4e38  # held in float32, as the reference's jnp.float32(3.4e38)
_INT32_MAX = 2**31 - 1


@dataclass
class GroupedPods:
    """Pod batch collapsed to distinct shapes."""

    membership: np.ndarray  # [G, R] bool — requirement rows per group
    requests_q: np.ndarray  # [G, D] int64 milli-units (rounded up)
    key_present: np.ndarray  # [G, K] bool
    counts: np.ndarray  # [G] int32 — pods per group
    group_of_pod: np.ndarray  # [P] int32


# -- plain torch versions ------------------------------------------------------


def _solve_rest_plain(compat, has_offering, group_ints, alloc_q, price):
    """The solve from the cube's two halves: fits,
    the cheapest-feasible-type argmin and pods-per-node (the rest of the
    reference's `_solve_parts`)."""
    D = alloc_q.shape[1]
    requests_q = group_ints[:, :D]
    counts = group_ints[:, D]
    fits = (requests_q[:, None, :] <= alloc_q[None, :, :]).all(dim=-1)  # [G, I]
    feasible = compat & fits & has_offering
    inf = torch.tensor(INF_PRICE, dtype=torch.float32, device=price.device)
    score = torch.where(feasible, price[None, :], inf)
    choice = torch.argmin(score, dim=-1).to(torch.int32)  # first index wins ties
    feasible_any = feasible.any(dim=-1)
    # pods-per-node for the chosen type: min over resource dims of
    # floor(alloc / request); request==0 dims don't constrain
    chosen_alloc = alloc_q[choice.long()]
    per_dim = torch.where(
        requests_q > 0,
        torch.div(chosen_alloc, requests_q.clamp(min=1), rounding_mode="floor"),
        _INT32_MAX,
    )
    pods_per_node = per_dim.min(dim=-1).values.clamp(min=0)
    return choice, feasible_any, pods_per_node, counts


def _count_finalize_plain(choice, feasible_any, pods_per_node, counts) -> torch.Tensor:
    """Fold a pass's group counts over the count-independent core: nodes via
    ceil division, unschedulable as the infeasible remainder; [G, 4] int32
    in the reference's packed order."""
    ok = feasible_any & (pods_per_node > 0)
    nodes = torch.where(
        ok, -torch.div(-counts, pods_per_node.clamp(min=1), rounding_mode="floor"), 0
    )
    unschedulable = torch.where(ok, 0, counts)
    return torch.stack(
        [choice.int(), feasible_any.int(), nodes.int(), unschedulable.int()], dim=1
    )


def _solve_parts_plain(
    group_bools, group_ints, req_compat, offer_compat, custom_need, available,
    offering_owner, alloc_q, price,
):
    """The count-INDEPENDENT solve math of the reference's `_solve_parts`:
    feasibility cube → cheapest-type argmin → pods-per-node."""
    R, I = req_compat.shape
    membership = group_bools[:, :R]
    key_present = group_bools[:, R:]
    compat = feas.membership_all_plain(membership, req_compat)
    has_offering = feas.offering_reduce_plain(
        membership, offer_compat, custom_need, key_present, available, offering_owner, I
    )
    return _solve_rest_plain(compat, has_offering, group_ints, alloc_q, price)


def solve_block_plain(*args) -> torch.Tensor:
    """[G, 4] int32 (choice, feasible, nodes, unschedulable) — the
    reference's `_solve_block`."""
    return _count_finalize_plain(*_solve_parts_plain(*args))


def solve_block_core_plain(*args) -> torch.Tensor:
    """[G, 3] int32 core rows (choice, feasible, pods-per-node) — the
    reference's `_solve_block_core`, counts ignored."""
    choice, feasible_any, pods_per_node, _ = _solve_parts_plain(*args)
    return torch.stack([choice.int(), feasible_any.int(), pods_per_node.int()], dim=1)


def delta_scatter_rows_plain(core, slots, rows) -> torch.Tensor:
    """core[slots[j]] = rows[j], in place, with the reference's scatter
    semantics (`core.at[slots].set(rows)`): a negative slot counts from the
    end, a slot outside [0, cap) is dropped; padding entries duplicate the
    last slot with the same row values."""
    cap = core.shape[0]
    s = slots.long()
    s = torch.where(s < 0, s + cap, s)
    keep = (s >= 0) & (s < cap)
    core[s[keep]] = rows[keep]
    return core


def solve_block_scatter_plain(core, slots, group_bools, group_ints, *catalog) -> torch.Tensor:
    """The frontier pass in plain torch: the core rows of the groups
    (solve_block_core_plain) scattered into `core` at `slots`
    (delta_scatter_rows_plain), in place. Returns `core`."""
    return delta_scatter_rows_plain(core, slots, solve_block_core_plain(group_bools, group_ints, *catalog))


def delta_finalize_plain(core, order, counts) -> torch.Tensor:
    """Gather this pass's group order from the resident core and fold in its
    counts — the reference's `_delta_finalize`."""
    rows = core[order.long()]
    return _count_finalize_plain(rows[:, 0], rows[:, 1].bool(), rows[:, 2], counts)


def delta_pass_plain(core, slots, group_bools, group_ints, order, counts, *catalog) -> torch.Tensor:
    """A delta pass with a frontier in plain torch: solve_block_scatter_plain
    (`core` written in place), then delta_finalize_plain. [Gb, 4] int32."""
    solve_block_scatter_plain(core, slots, group_bools, group_ints, *catalog)
    return delta_finalize_plain(core, order, counts)


# -- kernel wrappers -----------------------------------------------------------

_lib_cache: list = []


def _group_lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = kernel_library("packer")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kt_group_solve.restype = ci
        lib.kt_group_solve.argtypes = [vp] * 11 + [ci] * 2 + [vp] + [ci] * 6 + [vp] * 4 + [ci] + [vp] * 2
        lib.kt_delta_scatter.restype = ci
        lib.kt_delta_scatter.argtypes = [vp] * 3 + [ci] * 2 + [vp]
        lib.kt_delta_finalize.restype = ci
        lib.kt_delta_finalize.argtypes = [vp] * 4 + [ci] * 2 + [vp]
        _lib_cache.append(lib)
    return _lib_cache[0]


# kt_group_solve's output modes (csrc/packer.cu): finalized [*, 4] rows (B9,
# B13), core [*, 3] rows (B10), core rows scattered into the residency's
# core matrix at their slots (B10 and B11 in one launch), and that scatter
# followed by the pass's finalize in the launch's last block (a delta pass
# with a frontier: B10, B11 and B12)
GROUP_MODES = {"finalize": 0, "core": 1, "scatter": 2, "pass": 3}
# uint64 entries at the head of kt_group_solve's timestamp buffer (the
# kernel's STAMP_HEAD): block 0's %globaltimer at its start and after the
# pack, the first window of usable offerings, the type pass and the
# reduction ([0, 5)), clock64 at the same points ([5, 10)), the least
# block start, greatest end, greatest start and longest block ([10, 14));
# then (start, end, SM) of each block. Null on every solve path;
# chip_smoke.py passes one.
GROUP_STAMPS = 16


class PackedCatalog(NamedTuple):
    """The group solver's catalog as kt_group_solve reads it, built once per
    catalog generation (pack_catalog): the requirement rows' compatibility
    with each type and each offering, and each offering's custom keys, as
    32-bit words (bit b of word w: row or key 32 w + b; uint32 bits held in
    int32), and each type's offering range (offerings are owner-major)."""

    req_words: torch.Tensor  # [WR, I] int32 — req_compat packed over rows
    offer_words: torch.Tensor  # [WR, O] int32 — offer_compat packed over rows
    need_words: torch.Tensor  # [WK, O] int32 — custom_need packed over keys
    type_start: torch.Tensor  # [I + 1] int32 — type i's offerings: [type_start[i], type_start[i+1])


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """[N, M] bool → [ceil(N / 32), M] int32 words: bit b of word w is
    bits[32 w + b] (rows past N are 0)."""
    return feas.pack_words(bits.T).T.contiguous()


def pack_catalog(req_compat: torch.Tensor, offer_compat: torch.Tensor, custom_need: torch.Tensor,
                 offering_owner: torch.Tensor) -> PackedCatalog:
    """kt_group_solve's packed catalog from the solver's catalog operands,
    on their device (a few torch ops: a caller that solves again on the
    same catalog keeps it, as GroupSolver does per catalog generation).
    `offering_owner` must be non-decreasing; owners outside [0, I) fall in
    no type's range."""
    I = req_compat.shape[1]
    types = torch.arange(I + 1, dtype=torch.int32, device=offering_owner.device)
    return PackedCatalog(
        pack_rows(req_compat), pack_rows(offer_compat), pack_rows(custom_need.T),
        torch.searchsorted(offering_owner, types).to(torch.int32),
    )


def _packed(rc, oc, cn, ow) -> PackedCatalog:
    """The catalog's PackedCatalog, packed on its first solve and reused
    while the four source tensors are the same objects, unchanged in place
    (their `_version`): a catalog that grows is a new tensor (the engine
    concatenates its rows), so it packs anew. Kept with the feasibility
    kernels' packs (feasibility._cached)."""
    return feas._cached(("group",), (rc, oc, cn, ow), lambda: pack_catalog(rc, oc, cn, ow))


def _group_operands(name: str, catalog: Sequence[torch.Tensor], dev) -> tuple:
    """kt_group_solve's catalog operands, checked on `dev`: (R, K, O, I,
    D), the seven pointers it reads, and the PackedCatalog they point into,
    which the caller keeps until the launch is queued. Shapes the kernel
    cannot take (no types; more row and key words than its shared memory
    holds) it refuses at launch, and the caller raises that as a
    KernelError."""
    rc, oc, cn, av, ow, aq, pr = catalog
    R, I = rc.shape
    O, K = cn.shape
    D = aq.shape[1]
    _check(f"{name} req_compat", rc, torch.bool, (R, I), dev)
    _check(f"{name} offer_compat", oc, torch.bool, (R, O), dev)
    _check(f"{name} custom_need", cn, torch.bool, (O, K), dev)
    _check(f"{name} available", av, torch.bool, (O,), dev)
    _check(f"{name} offering_owner", ow, torch.int32, (O,), dev)
    _check(f"{name} alloc_q", aq, torch.int32, (I, D), dev)
    _check(f"{name} price", pr, torch.float32, (I,), dev)
    packed = _packed(rc, oc, cn, ow)
    ptrs = (_ptr(packed.req_words), _ptr(packed.offer_words), _ptr(packed.need_words), _ptr(av),
            _ptr(packed.type_start), _ptr(aq), _ptr(pr))
    return (R, K, O, I, D), ptrs, packed


def _group_solve(name: str, mode: str, group_bools, group_ints, catalog, out=None, slots=None,
                 stamps=None, order=None, counts=None, counter=None) -> torch.Tensor:
    """One kt_group_solve launch over every group row (a one-slab table),
    reading membership and key_present in place from group_bools. `mode`
    "finalize" and "core" allocate the [G, 4] / [G, 3] output and return it;
    "scatter" writes the core rows into `out`, the [cap, 3] core matrix, at
    `slots` and returns `out`; "pass" scatters so, then returns the [Gb, 4]
    rows of `order` finalized against `counts` (the launch's last block
    knows itself last by `counter`, one int32 the C entry zeroes first).
    `stamps`: None, or a [GROUP_STAMPS + 3 G] int64 tensor on the card for
    the kernel's timestamps. Counted under `name`."""
    dev = group_bools.device
    # `packed` stays referenced until the launch is queued
    (R, K, O, I, D), cat, packed = _group_operands(name, catalog, dev)
    G = group_bools.shape[0]
    _check(f"{name} group_bools", group_bools, torch.bool, (G, R + K), dev)
    _check(f"{name} group_ints", group_ints, torch.int32, (G, D + 1), dev)
    fout, n_out, tail = None, 0, (None, None, None)
    if mode in ("scatter", "pass"):
        cap = out.shape[0]
        _check(f"{name} core", out, torch.int32, (cap, 3), dev)
        _check(f"{name} slots", slots, torch.int32, (G,), dev)
        if mode == "pass":
            if G == 0:
                raise KernelError(f"{name}: a pass without frontier rows is delta_finalize's")
            n_out = order.shape[0]
            _check(f"{name} order", order, torch.int32, (n_out,), dev)
            _check(f"{name} counts", counts, torch.int32, (n_out,), dev)
            _check(f"{name} counter", counter, torch.int32, (1,), dev)
            fout = torch.empty((n_out, 4), dtype=torch.int32, device=dev)
            tail = (_ptr(order), _ptr(counts), _ptr(fout))
    else:
        cap = 0
        out = torch.empty((G, 4 if mode == "finalize" else 3), dtype=torch.int32, device=dev)
    if stamps is not None:
        _check(f"{name} stamps", stamps, torch.int64, (GROUP_STAMPS + 3 * G,), dev)
    if G == 0:
        return out
    err = launch(
        dev, _group_lib().kt_group_solve, _ptr(group_bools), _ptr(group_ints), *cat, _ptr(out),
        None if slots is None else _ptr(slots), cap, GROUP_MODES[mode], (ctypes.c_int * 3)(0, G, 0), 1,
        R, K, O, I, D, None if stamps is None else _ptr(stamps), *tail, n_out,
        None if counter is None else _ptr(counter),
    )
    if err != 0:
        raise KernelError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1
    return out if fout is None else fout


def solve_block(
    group_bools: torch.Tensor,  # [G, R+K] bool — membership | key_present packed
    group_ints: torch.Tensor,  # [G, D+1] int32 — requests_q | counts packed
    req_compat: torch.Tensor,  # [R, I] bool
    offer_compat: torch.Tensor,  # [R, O] bool
    custom_need: torch.Tensor,  # [O, K] bool
    available: torch.Tensor,  # [O] bool
    offering_owner: torch.Tensor,  # [O] int32, non-decreasing (owner-major offerings)
    alloc_q: torch.Tensor,  # [I, D] int32
    price: torch.Tensor,  # [I] float32 — cheapest available offering per type
) -> torch.Tensor:
    """The fused per-group solve (B9): feasibility cube → cheapest-type
    argmin → integer packing; [G, 4] int32 (choice, feasible, nodes,
    unschedulable). Takes owner indices where the reference takes the
    [O, I] one-hot. On the card one kt_group_solve launch, finalize mode,
    reading the catalog packed into words (packed on the catalog's first
    solve and kept while its tensors stay unchanged)."""
    catalog = (req_compat, offer_compat, custom_need, available, offering_owner, alloc_q, price)
    if _on_cpu(group_bools):
        return solve_block_plain(group_bools, group_ints, *catalog)
    return _group_solve("solve_block", "finalize", group_bools, group_ints, catalog)


def solve_block_core(group_bools: torch.Tensor, group_ints: torch.Tensor, *catalog) -> torch.Tensor:
    """[Gf, 3] int32 core rows (choice, feasible, pods-per-node) for the
    perturbed frontier (B10) — `solve_block`'s math without the count
    finalize. Same operands as solve_block; on the card one kt_group_solve
    launch, core mode."""
    if _on_cpu(group_bools):
        return solve_block_core_plain(group_bools, group_ints, *catalog)
    return _group_solve("solve_block_core", "core", group_bools, group_ints, catalog)


def solve_block_scatter(core: torch.Tensor, slots: torch.Tensor, group_bools: torch.Tensor,
                        group_ints: torch.Tensor, *catalog) -> torch.Tensor:
    """The delta frontier pass: the groups' core rows (B10) written into
    the resident [cap, 3] core matrix at `slots` (B11), IN PLACE; returns
    `core`. Slots as delta_scatter_rows takes them: a negative slot counts
    from the end, one outside [0, cap) is dropped, edge-padded duplicates
    must carry groups that solve alike. On the card one kt_group_solve
    launch, scatter mode: no [Gf, 3] rows reach device memory."""
    if _on_cpu(core):
        return solve_block_scatter_plain(core, slots, group_bools, group_ints, *catalog)
    return _group_solve("solve_block_scatter", "scatter", group_bools, group_ints, catalog,
                        out=core, slots=slots)


def delta_scatter_rows(core: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Scatter freshly solved frontier rows into the resident core matrix
    (B11): core[slots[j], :] = rows[j, :], written IN PLACE (the reference
    donates `core` to XLA); a negative slot counts from the end, a slot
    outside [0, cap) is dropped, duplicate slots carry the same values.
    Returns `core`. The delta frontier runs it inside solve_block_scatter's
    launch; this wrapper launches kt_delta_scatter alone."""
    if _on_cpu(core):
        return delta_scatter_rows_plain(core, slots, rows)
    dev = core.device
    cap, n = core.shape[0], slots.shape[0]
    _check("delta_scatter core", core, torch.int32, (cap, 3), dev)
    _check("delta_scatter slots", slots, torch.int32, (n,), dev)
    _check("delta_scatter rows", rows, torch.int32, (n, 3), dev)
    rc = launch(dev, _group_lib().kt_delta_scatter, core.data_ptr(), slots.data_ptr(), rows.data_ptr(),
                n, cap)
    if rc != 0:
        raise KernelError(f"delta_scatter: CUDA launch failed with cudaError {rc}")
    LAUNCHES["delta_scatter"] += bool(n)
    return core


def delta_pass(core: torch.Tensor, slots: torch.Tensor, group_bools: torch.Tensor,
               group_ints: torch.Tensor, order: torch.Tensor, counts: torch.Tensor, *catalog,
               counter: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A delta pass with a frontier: the frontier's core rows written into
    the resident [cap, 3] core matrix at `slots` (solve_block_scatter, IN
    PLACE), then this pass's [Gb, 4] int32 rows gathered in `order` and
    finalized against `counts` (delta_finalize). On the card one
    kt_group_solve launch, pass mode (B10 + B11 + B12): the launch's last
    block to finish runs the finalize. `counter`: one int32 on the card
    that the launch counts its blocks in, the caller's own (a
    GroupResidency keeps one; two launches queued at once must not share
    one); None allocates one. The frontier needs at least one row (a pass
    without one is delta_finalize's)."""
    if _on_cpu(core):
        return delta_pass_plain(core, slots, group_bools, group_ints, order, counts, *catalog)
    if counter is None:
        counter = torch.empty(1, dtype=torch.int32, device=core.device)
    return _group_solve("delta_pass", "pass", group_bools, group_ints, catalog, out=core, slots=slots,
                        order=order, counts=counts, counter=counter)


def delta_finalize(core: torch.Tensor, order: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[Gb, 4] int32: the resident core rows gathered in this pass's group
    order (B12), nodes and unschedulable finalized against its counts — the
    same finalize as solve_block. Order entries must lie in [0, cap). A
    delta pass without a frontier launches it alone; one with a frontier
    runs it inside delta_pass's launch."""
    if _on_cpu(core):
        return delta_finalize_plain(core, order, counts)
    dev = core.device
    cap, Gb = core.shape[0], order.shape[0]
    _check("delta_finalize core", core, torch.int32, (cap, 3), dev)
    _check("delta_finalize order", order, torch.int32, (Gb,), dev)
    _check("delta_finalize counts", counts, torch.int32, (Gb,), dev)
    out = torch.empty((Gb, 4), dtype=torch.int32, device=dev)
    rc = launch(
        dev, _group_lib().kt_delta_finalize, _ptr(core), _ptr(order), _ptr(counts), _ptr(out), Gb, cap
    )
    if rc != 0:
        raise KernelError(f"delta_finalize: CUDA launch failed with cudaError {rc}")
    LAUNCHES["delta_finalize"] += bool(Gb)
    return out


def sharded_solve_block(mesh):
    """solve_block over a mesh (B13), a callable with solve_block's
    signature: the groups split into one equal slab per shard (the caller
    pads them to a multiple of the mesh size), the seven catalog operands
    replicated (or given as per-shard tuples), and the [G, 4] rows gathered
    in shard order on the first shard's device. No collective inside the
    solve, as in the reference's shard_map.

    On a CUDA mesh, one launch of kt_group_solve per card solves every
    shard the card holds (`_sharded_solve_block_cuda`), counted once per
    card under `sharded_solve_block`, reading each card's catalog packed
    once per catalog (as solve_block does). On a CPU mesh each shard runs solve_block_plain on its own slab."""

    def run(group_bools, group_ints, *catalog):
        if mesh.devices[0].type == "cuda":
            return _sharded_solve_block_cuda(mesh, group_bools, group_ints, catalog)
        gb_s = mesh_mod.split_rows(group_bools, mesh)
        gi_s = mesh_mod.split_rows(group_ints, mesh)
        rep = [mesh_mod.per_shard(x, mesh) for x in catalog]
        parts = [solve_block(gb_s[s], gi_s[s], *(r[s] for r in rep)) for s in range(mesh.size)]
        return mesh_mod.gather_rows(parts, mesh)

    return run


def _sharded_solve_block_cuda(mesh, group_bools, group_ints, catalog) -> torch.Tensor:
    """sharded_solve_block on the card: the entity operands checked in one
    pass (host or device tensors, both on one device), the replicated
    catalog as mesh.Replicas, checked per card; per card one upload of its
    group rows (group_bools and group_ints through one staging buffer,
    mesh.stage_rows), its [rows, 4] output allocated once (card 0's is the
    gathered result) and one kt_group_solve launch over its shards, reading
    membership and key_present in place from group_bools; every card's
    launch is queued before mesh.gather_cards."""
    name = "sharded_solve_block"
    reps = tuple(mesh_mod.per_shard(x, mesh) for x in catalog)
    R, I = reps[0][0].shape
    O, K = reps[2][0].shape
    D = reps[5][0].shape[1]
    G = group_bools.shape[0]
    src = group_bools.device
    _check(f"{name} group_bools", group_bools, torch.bool, (G, R + K), src)
    _check(f"{name} group_ints", group_ints, torch.int32, (G, D + 1), src)
    plan = mesh_mod.slab_plan(mesh.devices, G)
    if max(len(slabs) for _, slabs in plan) > feas._MAX_SLABS:
        raise KernelError(f"{name}: {mesh.size} shards exceed the kernel's slab table")
    cards = []  # per card: its catalog pointers and the PackedCatalog they point into
    for dev, slabs in plan:
        s = slabs[0][0]  # a shard on this card, for its catalog copies
        cards.append(_group_operands(name, [r[s] for r in reps], dev)[1:])
    dev0 = mesh.devices[0]
    out = torch.empty((G, 4), dtype=torch.int32, device=dev0)
    if G == 0:
        return out
    m = G // mesh.size
    others = []
    for (dev, slabs), (cat, _) in zip(plan, cards):
        # `keep` holds staged rows until their launch is queued
        (gb, gi), starts, keep = mesh_mod.stage_rows((group_bools, group_ints), slabs, dev)
        if dev == dev0:
            o, dsts = out, [lo for _, lo, _ in slabs]
        else:
            o = torch.empty((len(slabs) * m, 4), dtype=torch.int32, device=dev)
            dsts = [k * m for k in range(len(slabs))]  # compact: the card's shards in order
            others.append((slabs, o))
        err = launch(
            dev, _group_lib().kt_group_solve, gb, gi, *cat, _ptr(o), None, 0, GROUP_MODES["finalize"],
            feas.slab_table(starts, slabs, dsts), len(slabs), R, K, O, I, D, None, None, None, None, 0,
            None,
        )
        if err != 0:
            raise KernelError(f"{name}: CUDA launch failed with cudaError {err}")
        LAUNCHES["sharded_solve_block"] += 1
    mesh_mod.gather_cards(out, others)
    return out


# -- host wrapper --------------------------------------------------------------


def _pack_groups(grouped: GroupedPods) -> tuple[np.ndarray, np.ndarray]:
    group_bools = np.concatenate([grouped.membership, grouped.key_present], axis=1)
    group_ints = np.concatenate(
        [grouped.requests_q.astype(np.int32), grouped.counts[:, None]], axis=1
    )
    return group_bools, group_ints


class GroupSolver:
    """Host wrapper: engine matrices + per-type prices, device solve."""

    def __init__(self, engine: CatalogEngine, mesh=None):
        self.engine = engine
        # an explicit mesh wins; otherwise inherit the engine's — a solver
        # built on a mesh engine serves sharded solves without every call
        # site knowing about meshes
        self.mesh = mesh if mesh is not None else engine.mesh
        if self.mesh is not None and self.mesh.devices[0].type != engine.device.type:
            raise ValueError(
                f"a mesh of {self.mesh.devices[0].type} devices for an engine on {engine.device}"
            )
        # cheapest available offering price per instance type
        price = np.full(engine.num_instances, np.inf, dtype=np.float32)
        for o_idx, owner in enumerate(engine.offering_owner):
            if engine.offering_available[o_idx]:
                price[owner] = min(price[owner], engine.offering_price[o_idx])
        self.price = price
        scales = feas.resource_scales(engine.resource_dims)
        self.alloc_q = feas.quantize_resources(
            engine.allocatable, ceil=False, scales=scales
        ).astype(np.int32)
        self._dev_args = None
        self._dev_rows = -1
        self._mesh_args = None
        self._mesh_args_key = None

    def _catalog_args(self) -> tuple:
        """The catalog operands on the engine's device, gathered once per
        row generation: the engine's resident compat matrices, its offering
        tables, and the quantized allocatable and prices (uploaded here)."""
        e = self.engine
        e._ensure_rows()
        if self._dev_args is not None and self._dev_rows == e._computed_rows:
            return self._dev_args
        dev = e.device
        with device_work("group solver catalog"):
            self._dev_args = (
                e._req_compat_d if e._computed_rows
                else torch.zeros((1, e.num_instances), dtype=torch.bool, device=dev),
                e._offer_compat_d if e._computed_rows
                else torch.zeros((1, e.num_offerings), dtype=torch.bool, device=dev),
                e._dev("custom_need", e.offering_custom_need),
                e._dev("available", e.offering_available),
                e._dev("owner", e.offering_owner),
                torch.from_numpy(self.alloc_q).to(dev),
                torch.from_numpy(self.price).to(dev),
            )
        self._dev_rows = e._computed_rows
        return self._dev_args

    def _mesh_catalog_args(self, mesh) -> tuple:
        """The catalog operands as per-shard tuples, replicated from the
        HOST copies once per (mesh, row-set) — the _catalog_args analogue
        for sharded solves."""
        e = self.engine
        e._ensure_rows()
        key = (mesh, e._computed_rows)
        if self._mesh_args_key == key:
            return self._mesh_args
        host = (
            e._req_compat if e._computed_rows else np.zeros((1, e.num_instances), bool),
            e._offer_compat if e._computed_rows else np.zeros((1, e.num_offerings), bool),
            e.offering_custom_need,
            e.offering_available,
            e.offering_owner,
            self.alloc_q,
            self.price,
        )
        with device_work("group solver mesh catalog"):
            cat = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
            self._mesh_args = tuple(mesh_mod.replicate(t, mesh) for t in cat)
        self._mesh_args_key = key
        return self._mesh_args

    def solve(self, grouped: GroupedPods):
        """Fused solve; returns host arrays (choice, feasible,
        nodes-per-group, unschedulable-per-group).

        With a mesh (GroupSolver(mesh=) or the engine's), the group axis
        shards across its devices through solve_sharded, ahead of the
        delta check: a mesh bypasses the group residency, as in the
        reference. Otherwise, with delta solves on (KARPENTER_TPU_DELTA /
        delta.configure), the solve routes through the per-solver residency
        (ops/delta.py): only the perturbed group frontier is re-solved and
        scattered into the card-resident core matrix."""
        from karpenter_tpu_torch.ops import delta as delta_mod

        if self.mesh is not None:
            return self.solve_sharded(grouped, self.mesh)
        if delta_mod.delta_enabled():
            return delta_mod.group_residency(self).solve(self, grouped)
        return self._solve_full(grouped)

    def _solve_full(self, grouped: GroupedPods):
        """The from-scratch solve — the delta path's seed, fallback, and
        periodic self-check oracle."""
        args = self._catalog_args()
        group_bools, group_ints = _pack_groups(grouped)
        G = group_bools.shape[0]
        dev = self.engine.device
        with device_work("group solve"):
            # the group rows in one staged upload (one pinned buffer, one copy)
            gb, gi = mesh_mod.upload_rows((group_bools, group_ints), dev)
            out = ktime.dispatch(
                solve_block, gb, gi, *args, kernel="packer.solve_block"
            ).cpu().numpy()[:G]
        return out[:, 0], out[:, 1].astype(bool), out[:, 2], out[:, 3]

    def solve_sharded(self, grouped: GroupedPods, mesh):
        """The solve over a mesh: groups sharded over its one axis, the
        catalog replicated. The group axis pads to the reference's mesh-size-
        INVARIANT global shape, pow2 aligned to lcm(n, MESH_ALIGN); padding
        rows carry counts 0, pack to 0 nodes / 0 unschedulable on whatever
        shard they land on (a shard of padding only computes zeros) and are
        sliced off."""
        n = mesh.size
        G = grouped.membership.shape[0]
        group_bools, group_ints = _pack_groups(grouped)
        align = mesh_mod.mesh_multiple(n)
        G2 = max(1 << max(0, (G - 1).bit_length()), align)
        G2 = -(-G2 // align) * align
        if G2 > G:
            pad = G2 - G
            group_bools = np.pad(group_bools, ((0, pad), (0, 0)))
            group_ints = np.pad(group_ints, ((0, pad), (0, 0)))
        args = self._mesh_catalog_args(mesh)
        with device_work("sharded group solve"):
            out = ktime.dispatch(
                sharded_solve_block(mesh),
                torch.from_numpy(np.ascontiguousarray(group_bools)),
                torch.from_numpy(np.ascontiguousarray(group_ints)),
                *args,
                kernel="packer.solve_block_sharded",
                aot_scope=feas.mesh_scope(mesh),
            ).cpu().numpy()
        return out[:G, 0], out[:G, 1].astype(bool), out[:G, 2], out[:G, 3]


def scatter_add_counts(
    counts: np.ndarray, idx: Sequence[int], amount: int = 1
) -> np.ndarray:
    """Unbuffered scatter-add of `amount` into `counts` at `idx` (duplicate
    indices accumulate, matching `jnp.ndarray.at[].add` semantics), growing
    the vector geometrically when an index lands past the end. This is the
    update primitive behind the topology count tensors (ops/topo_counts.py):
    one placement batch scatters its (group, domain) increments in a single
    call instead of a per-domain dict walk."""
    idx = np.asarray(idx, dtype=np.int64)
    if idx.size == 0:
        return counts
    hi = int(idx.max())
    if hi >= counts.shape[0]:
        grown = np.zeros(max(hi + 1, counts.shape[0] * 2), dtype=counts.dtype)
        grown[: counts.shape[0]] = counts
        counts = grown
    np.add.at(counts, idx, amount)
    return counts


def merge_shard_group_counts(
    shard_group_ids: Sequence[np.ndarray],
    num_groups: int,
    shard_amounts: Optional[Sequence[np.ndarray]] = None,
) -> np.ndarray:
    """Segment-reduce per-shard group-membership streams into ONE global
    [num_groups] count vector — the claim-emission merge for a pod-axis-
    sharded encode, where one group's pods may land on several shards and
    each shard only knows its local tally. Ids past num_groups are padding
    rows (the mesh-alignment remainder) and are MASKED OUT, never counted.
    With `shard_amounts`, entry j of shard s contributes amounts[s][j]
    instead of 1 (pre-reduced per-shard count tensors merge the same way).
    Semantics match np.add.at over the concatenated streams — duplicates
    accumulate, exactly like scatter_add_counts and the host dict walk.
    NOTE: the shipped encode (encode_pods_for_packer) groups on the host
    before sharding, so group counts arrive whole; this is the merge
    primitive for encodes that split the raw pod stream across shards
    (spec'd against the concatenated-scatter oracle in tests/test_mesh.py)."""
    out = np.zeros(num_groups, dtype=np.int64)
    for s, ids in enumerate(shard_group_ids):
        ids = np.asarray(ids, dtype=np.int64).reshape(-1)
        amounts = (
            np.ones(ids.shape[0], dtype=np.int64)
            if shard_amounts is None
            else np.asarray(shard_amounts[s], dtype=np.int64).reshape(-1)
        )
        keep = (ids >= 0) & (ids < num_groups)
        np.add.at(out, ids[keep], amounts[keep])
    return out


def encode_pods_for_packer(
    engine: CatalogEngine,
    pods_requirements: Sequence[Requirements],
    requests: np.ndarray,
    cache=None,
) -> GroupedPods:
    """Requirements → engine rows → groups (the host-side encode step).
    Requirements objects repeated by identity (one object per workload
    shape) encode once. With a delta `EncodeCache` (ops/delta.py), shapes
    already encoded in PREVIOUS passes reuse their interned row ids,
    membership rows, and key-presence rows — a churn pass re-encodes only
    the shapes it has never seen, and bytes re-encoded are metered."""
    from karpenter_tpu_torch.ops import delta as delta_mod

    if cache is None:
        cache = delta_mod.encode_cache(engine)  # None unless delta solves are on
    if cache is not None:
        return _encode_pods_delta(engine, pods_requirements, requests, cache)
    shape_of: dict[int, int] = {}
    distinct: list[Requirements] = []
    shape_ids = np.empty(len(pods_requirements), dtype=np.int64)
    for p, reqs in enumerate(pods_requirements):
        sid = shape_of.get(id(reqs))
        if sid is None:
            sid = len(distinct)
            shape_of[id(reqs)] = sid
            distinct.append(reqs)
        shape_ids[p] = sid
    distinct_rows = [engine.rows_for(reqs) for reqs in distinct]
    kp_distinct = engine.key_presence(distinct)
    engine._ensure_rows()

    # Vectorized grouping: unique over (shape id, quantized request row).
    scales = feas.resource_scales(engine.resource_dims)
    requests_q = feas.quantize_resources(requests, ceil=True, scales=scales)
    combined = np.column_stack([shape_ids, requests_q])
    uniq, inverse, counts = np.unique(
        combined, axis=0, return_inverse=True, return_counts=True
    )
    G = uniq.shape[0]
    R = max(1, engine.num_rows)
    membership = np.zeros((G, R), dtype=bool)
    for g in range(G):
        for rid in distinct_rows[int(uniq[g, 0])]:
            membership[g, rid] = True
    return GroupedPods(
        membership=membership,
        requests_q=uniq[:, 1:],
        key_present=kp_distinct[uniq[:, 0].astype(np.int64)],
        counts=counts.astype(np.int32),
        group_of_pod=inverse.astype(np.int32),
    )


def _encode_pods_delta(
    engine: CatalogEngine,
    pods_requirements: Sequence[Requirements],
    requests: np.ndarray,
    cache,
) -> GroupedPods:
    """The incremental encode: per-shape lookups against the cross-pass
    EncodeCache; only cache misses touch `engine.rows_for`/`key_presence`.
    Output is bit-identical to the one-shot encode — the same dedup,
    quantization, and np.unique grouping over the same interned rows."""
    cache.begin_pass()
    shape_of: dict[int, int] = {}
    distinct: list[Requirements] = []
    shape_ids = np.empty(len(pods_requirements), dtype=np.int64)
    for p, reqs in enumerate(pods_requirements):
        sid = shape_of.get(id(reqs))
        if sid is None:
            sid = len(distinct)
            shape_of[id(reqs)] = sid
            distinct.append(reqs)
        shape_ids[p] = sid
    entries = [cache.lookup(engine, reqs, engine.num_rows) for reqs in distinct]
    engine._ensure_rows()

    scales = feas.resource_scales(engine.resource_dims)
    requests_q = feas.quantize_resources(requests, ceil=True, scales=scales)
    combined = np.column_stack([shape_ids, requests_q])
    uniq, inverse, counts = np.unique(
        combined, axis=0, return_inverse=True, return_counts=True
    )
    G = uniq.shape[0]
    R = max(1, engine.num_rows)
    membership = np.zeros((G, R), dtype=bool)
    key_present = np.zeros((G, entries[0][2].shape[0]) if entries else (G, 0), dtype=bool)
    for g in range(G):
        _, mrow, kp = entries[int(uniq[g, 0])]
        membership[g, : mrow.shape[0]] = mrow[:R]
        key_present[g] = kp
    cache.end_pass()
    return GroupedPods(
        membership=membership,
        requests_q=uniq[:, 1:],
        key_present=key_present,
        counts=counts.astype(np.int32),
        group_of_pod=inverse.astype(np.int32),
    )


# == the fused FFD scan ========================================================

SCAN_OK = 0
SCAN_CLAIM_OVERFLOW = 1
SCAN_QUEUE_OVERFLOW = 2

_KIND_REJECT, _KIND_SAME, _KIND_NARROW = 0, 1, 2
_SCAN_EPS = 1e-9

# the host heap key (count, rank, ci) packed into one int64: count and rank
# are bounded by the queue length (< 2**20), ci by the claim bucket
# (< 2**18), so the packing is order-isomorphic to the tuple
_SCAN_KEY_MAX = 1 << 62

# operand layout: 27 verdict/stream operands (ops/fused.py builds them),
# the reference's 10 outputs (abort, nclaims, pod_claim, pod_node, pod_seq,
# claim_ti, claim_fam, u_valid, tm_st, pool_rem); the port returns `steps`
# after them
SCAN_N_ARGS = 27
SCAN_N_OUT = 10
# the reference's loop state has 23 components: seven scalars (head, tail,
# stop, abort, seqc, done, nclaims) and 16 arrays. The port holds the
# scalars in one int32 vector `scal` (its 8th entry counts the loop
# iterations of the last launch), so its state is `scal` + the 16 tensors
SCAN_N_STATE = 23
SCAN_STATE_FIELDS = (
    "scal", "queue", "last_len", "pod_claim", "pod_node", "pod_seq",
    "claim_ti", "claim_fam", "claim_count", "claim_key", "u_valid", "rem",
    "cfit", "nptr", "node_rem", "tm_st", "pool_rem",
)
_N_SCALARS = 7
# final-state indices (the reference's 23-component numbering) the classic
# 10-output solve exposes
_SCAN_OUT_IDX = (3, 6, 9, 10, 11, 12, 13, 16, 21, 22)


def scan_component(state: tuple, i: int) -> torch.Tensor:
    """Component i of the reference's 23-component state, from the port's
    (scal, 16 tensors): scalars are 0-d int32 views of scal."""
    return state[0][i] if i < _N_SCALARS else state[i - _N_SCALARS + 1]


def _scan_finals(state: tuple) -> tuple:
    """(abort, nclaims, pod_claim, pod_node, pod_seq, claim_ti, claim_fam,
    u_valid, tm_st, pool_rem) — the decode subset of the full state."""
    return tuple(scan_component(state, i) for i in _SCAN_OUT_IDX)


def _scan_key(count: int, rank: int, ci: int) -> int:
    return count * (1 << 39) + (rank + (1 << 20)) * (1 << 18) + ci


def _scan_dims(cfg: tuple, args: tuple) -> dict:
    T, has_nodes, has_limits = cfg
    P = args[0].shape[0]
    G, D = args[2].shape
    return {
        "P": P, "G": G, "D": D, "U": args[4].shape[0], "C": args[1].shape[0],
        "Qcap": 4 * P + 64,
        "N": args[15].shape[0] if has_nodes else 1,
        "I": args[18].shape[1] if has_limits else 1,
        "L": args[24].shape[0] if has_limits else 1,
        "T": T, "F": args[10].shape[0], "limits": bool(has_limits),
    }


# the kernel's two designs (csrc/scan.cu): "resident" keeps the claim state
# and the constant tables in shared memory for the whole launch, "global"
# keeps the loop state in the caller's global buffers. The wrapper takes
# the resident one whenever its set fits the shared memory a block may use.
SCAN_SMEM_PER_BLOCK = 232448  # bytes a block may use on sm_90 (227 KB)
SCAN_STATIC_RESERVE = 1024  # of them, the resident kernel's static scalars (ResShared)
# the resident design's block size: the fastest bit-identical one of 256,
# 512 and 1024 threads on the H100 (PERF.md, the kernel table)
SCAN_THREADS = 256


def scan_resident_bytes(d: dict) -> int:
    """The resident design's dynamic shared memory in bytes for the scan
    dims `d` (C, G, U, D, T, F, I and limits, as `_scan_dims` gives them):
    csrc/scan.cu `res_layout`, array by array, widest elements first. Per
    claim its key (8 bytes), claim_ti, claim_count and claim_fam (4 each),
    u_valid as ceil(U/32) words; per group g_req and g_floor (8 D each) and
    a cfit bit row of ceil(C/32) words, padded to an odd count; per
    (family, group) trans_fam (int16) and trans_kind (1 byte); per (template,
    group) open_fam (4), open_uok words, tol and open_ok (1 each); famu_ok as
    T F words; uniq_alloc and the step's committed rem row (8 U D each),
    usage0 (8 T D), one dirty bit per claim, a join's misses as U D bits;
    the limits variant adds its pool charge (8
    D), two uid words, the taken template's uids (U bytes) and three type
    masks (I bytes each). Rounded up to 16."""
    C, G, U, D, T, F, I, lim = (d[k] for k in ("C", "G", "U", "D", "T", "F", "I", "limits"))
    wc, wu = -(-C // 32), -(-U // 32)
    n = 8 * (C + 2 * G * D + 2 * U * D + T * D + (D if lim else 0))
    n += 4 * (G * (wc | 1) + C * wu + 3 * C + T * F * wu + T * G * wu + T * G + wc + -(-U * D // 32)
              + (2 * wu if lim else 0))
    n += 2 * F * G + F * G + 2 * T * G + ((U + 3 * I) if lim else 0)
    return -(-n // 16) * 16


def scan_design(cfg: tuple, args: tuple) -> str:
    """"resident" when the resident set of these operands' dims fits (and
    trans_fam fits int16), else "global": a function of the shapes alone,
    never of the values or of a failed launch."""
    d = _scan_dims(cfg, args)
    fits = scan_resident_bytes(d) + SCAN_STATIC_RESERVE <= SCAN_SMEM_PER_BLOCK and d["F"] <= 32767
    return "resident" if fits else "global"


def _state_spec(cfg: tuple, args: tuple) -> tuple:
    """(name, shape, dtype) of each state tensor, SCAN_STATE_FIELDS order —
    the reference's `_scan_init` shapes."""
    d = _scan_dims(cfg, args)
    P, G, D, U, C = d["P"], d["G"], d["D"], d["U"], d["C"]
    i32, i64, f64, b = torch.int32, torch.int64, torch.float64, torch.bool
    shapes = (
        ((8,), i32), ((d["Qcap"],), i32), ((P,), i32), ((P,), i32), ((P,), i32),
        ((P,), i32), ((C,), i32), ((C,), i32), ((C,), i32), ((C,), i64),
        ((C, U), b), ((C, U, D), f64), ((C, G), b), ((G,), i32),
        ((d["N"], D), f64), ((C, d["I"]), b), ((d["L"], D), f64),
    )
    return tuple((name, shape, dt) for name, (shape, dt) in zip(SCAN_STATE_FIELDS, shapes))


# -- plain torch version -------------------------------------------------------


def _scan_init_plain(cfg: tuple, args: tuple) -> tuple:
    """The cold-start loop state (the reference's `_scan_init`)."""
    T, has_nodes, has_limits = cfg
    dev = args[0].device
    st = {name: torch.zeros(shape, dtype=dt, device=dev) for name, shape, dt in _state_spec(cfg, args)}
    P = args[0].shape[0]
    st["scal"][1] = int(args[13])  # tail = n_pods
    st["queue"][:P] = torch.arange(P, dtype=torch.int32, device=dev)
    for name in ("last_len", "pod_claim", "pod_node", "pod_seq"):
        st[name].fill_(-1)
    st["claim_key"].fill_(_SCAN_KEY_MAX)
    if has_nodes:
        st["node_rem"].copy_(args[16])
    if has_limits:
        st["pool_rem"].copy_(args[24])
    return tuple(st[name] for name in SCAN_STATE_FIELDS)


def _scan_loop_plain(cfg: tuple, args: tuple, state: tuple) -> None:
    """The scan as a Python loop over float64/int64 tensors, one queue pop
    per iteration, mirroring the reference's (cond, body). Runs from
    `state` and writes it in place; scal[7] gets this call's iteration
    count. Every write the reference makes on a step, including the no-op
    ones, lands on the same cells."""
    T, has_nodes, has_limits = cfg
    (
        pod_gi, claim_pad, g_req, g_floor, uniq_alloc, usage0, tol, open_ok,
        open_fam, open_uok, trans_kind, trans_fam, famu_ok, n_pods, n_nodes,
        node_ok, node_rem0, fam_mask, tmpl_mask, open_cand, uid_onehot,
        uid_of_type, cap_f, pool_of_t, pool_rem0, pool_has, pool_bad,
    ) = args
    (
        scal, queue, last_len, pod_claim, pod_node, pod_seq, claim_ti, claim_fam,
        claim_count, claim_key, u_valid, rem, cfit, nptr, node_rem, tm_st, pool_rem,
    ) = state
    dev = pod_gi.device
    C = claim_pad.shape[0]
    Qcap = queue.shape[0]
    n_nodes = int(n_nodes)
    head, tail, stop, abort, seqc, done, nclaims = scal[:_N_SCALARS].tolist()
    stop = bool(stop)
    steps = 0
    claim_idx = torch.arange(C, device=dev)
    node_idx = torch.arange(node_ok.shape[0], device=dev) if has_nodes else None
    key_max = torch.tensor(_SCAN_KEY_MAX, dtype=torch.int64, device=dev)
    uid_of_type_l = uid_of_type.long()

    def fresh_cfit_row(ti, fam, uv, rem_row, tm_row):
        kindg = trans_kind[fam]
        f2g = trans_fam[fam].long()
        if has_limits:
            keep = uid_project_plain(uid_onehot, fam_mask[f2g] & tm_row[None, :])
        else:
            keep = famu_ok[ti][f2g]
        keep = keep & uv[None, :]
        fits = (rem_row[None, :, :] >= g_floor[:, None, :]).all(dim=-1)
        return (kindg != _KIND_REJECT) & tol[ti] & (keep & fits).any(dim=-1)

    while head < tail and not stop and abort == SCAN_OK:
        steps += 1
        pod = int(queue[head])
        g = int(pod_gi[pod])
        stop_now = int(last_len[pod]) == tail - head

        # -- existing-node scan (host _try_nodes) --
        any_node, jn = False, 0
        if has_nodes:
            greq = g_req[g]
            fit_n = torch.where(greq[None, :] > 0, node_rem + _SCAN_EPS >= greq[None, :], True).all(dim=-1)
            cand_n = (node_idx >= int(nptr[g])) & (node_idx < n_nodes) & node_ok[:, g] & fit_n
            hits = torch.nonzero(cand_n)
            if hits.numel():
                any_node, jn = True, int(hits[0, 0])

        # -- in-flight claims, emptiest first (host _try_claims) --
        cand_c = cfit[:, g] & (claim_idx < nclaims)
        any_claim = (not any_node) and bool(cand_c.any())
        ci = int(torch.argmin(torch.where(cand_c, claim_key, key_max)))
        c_ti = int(claim_ti[ci])
        f2 = int(trans_fam[int(claim_fam[ci]), g])
        new_tm = None
        if has_limits:
            new_tm = tm_st[ci] & fam_mask[f2]
            keep_u = uid_project_plain(uid_onehot, new_tm)
        else:
            keep_u = famu_ok[c_ti, f2]
        keep_u = keep_u & u_valid[ci]
        fit_u = keep_u & (rem[ci] >= g_floor[g][None, :]).all(dim=-1)

        # -- open a new claim (host _new_claim, template order) --
        want_open = (not any_node) and (not any_claim)
        sel_ti, sel_uv, sel_tm, sel_sub = -1, None, None, None
        for ti in range(T):
            if not want_open:
                break
            ok_t = bool(open_ok[ti, g]) and bool(tol[ti, g])
            if has_limits:
                pool = int(pool_of_t[ti])
                limited = pool >= 0
                pl = max(pool, 0)
                lm = torch.where(
                    pool_has[pl][None, :], cap_f <= pool_rem[pl][None, :] + _SCAN_EPS, True
                ).all(dim=-1) & ~pool_bad[pl]
                any_left = bool((lm & tmpl_mask[ti]).any())
                cand_t = open_cand[ti, g] & lm
                live_u = uid_project_plain(uid_onehot, cand_t)
                uv_t = open_uok[ti, g] & live_u if limited else open_uok[ti, g]
                if limited:
                    ok_t = ok_t and any_left and bool(uv_t.any())
                tm_t = cand_t if limited else open_cand[ti, g]
                # host _subtract_max: max capacity over the claim's narrowed
                # option set, subtracted from the pool's tracked dims
                sub_mask = tm_t & uv_t[uid_of_type_l]
                maxes = torch.where(sub_mask[:, None], cap_f, float("-inf")).max(dim=0).values
                if not bool(sub_mask.any()):
                    maxes = torch.zeros_like(maxes)
                sub = torch.zeros_like(pool_rem)
                sub[pl] += torch.where(pool_has[pl] & limited, maxes, 0.0)
            else:
                uv_t, tm_t, sub = open_uok[ti, g], None, None
            if ok_t:
                sel_ti, sel_uv, sel_tm, sel_sub = ti, uv_t, tm_t, sub
                break
        do_open = want_open and sel_ti >= 0
        overflow_c = do_open and nclaims >= C
        do_open = do_open and not overflow_c

        placed = any_node or any_claim or do_open
        failed = (not placed) and (not stop_now)

        # -- commit --
        adv = not stop_now
        join, opening = any_claim and adv, do_open and adv
        if has_nodes:
            if any_node and adv:
                node_rem[jn] = node_rem[jn] - g_req[g]
            if adv:
                nptr[g] = jn if any_node else n_nodes

        row = ci if any_claim else (nclaims if do_open else 0)
        row = min(row, C - 1)
        touch = join or opening
        seq2 = seqc + 1 if touch else seqc
        if join:
            rem[row] = rem[row] - g_req[g][None, :]
            u_valid[row] = fit_u
            claim_fam[row] = f2
            claim_count[row] += 1
            claim_key[row] = _scan_key(int(claim_count[row]), -seq2, row)
            if has_limits:
                tm_st[row] = new_tm
        elif opening:
            rem[row] = uniq_alloc - (usage0[sel_ti] + g_req[g])[None, :]
            u_valid[row] = sel_uv
            claim_ti[row] = sel_ti
            claim_fam[row] = open_fam[sel_ti, g]
            claim_count[row] = 1
            claim_key[row] = _scan_key(1, seq2, row)
            if has_limits:
                tm_st[row] = sel_tm
                pool_rem.sub_(sel_sub)
        if opening:
            nclaims += 1
        # cfit row refresh for the touched claim (a pure function of the
        # row's state, so refreshing an untouched row 0 is a no-op)
        cfit[row] = fresh_cfit_row(
            int(claim_ti[row]), int(claim_fam[row]), u_valid[row], rem[row],
            tm_st[row] if has_limits else None,
        )

        # pod bookkeeping
        head2 = head + 1 if adv else head
        pod_claim[pod] = ci if join else (row if opening else -1)
        pod_node[pod] = jn if (has_nodes and any_node and adv) else -1
        if placed and adv:
            pod_seq[pod] = done
            done += 1
        # failure: requeue + cycle-detection bookkeeping
        overflow_q = failed and tail >= Qcap
        tail2 = tail
        if failed and not overflow_q:
            queue[tail] = pod
            tail2 = tail + 1
        if failed and adv:
            last_len[pod] = tail2 - head2
        if overflow_c:
            abort = SCAN_CLAIM_OVERFLOW
        elif overflow_q:
            abort = SCAN_QUEUE_OVERFLOW
        stop = stop or stop_now
        head, tail, seqc = head2, tail2, seq2

    scal.copy_(torch.tensor(
        [head, tail, int(stop), abort, seqc, done, nclaims, steps], dtype=torch.int32, device=dev
    ))


def _enqueue_suffix_plain(args: tuple, state: tuple, p_lo: int) -> None:
    """Resume's enqueue (the reference's `_solve_scan_resume_core`): queue
    positions [tail, tail+nsuf) take pod ids p_lo+k, then tail += nsuf."""
    scal, queue = state[0], state[1]
    tail = int(scal[1])
    nsuf = max(int(args[13]) - int(p_lo), 0)
    k = torch.arange(nsuf, dtype=torch.int64, device=queue.device)
    queue[(tail + k).clamp(0, queue.shape[0] - 1)] = (int(p_lo) + k).to(torch.int32)
    scal[1] = tail + nsuf


def solve_scan_full_plain(cfg: tuple, args: tuple) -> tuple:
    """The cold scan returning its whole final state (SCAN_STATE_FIELDS),
    then the iteration count."""
    state = _scan_init_plain(cfg, args)
    _scan_loop_plain(cfg, args, state)
    return state + (state[0][7],)


def solve_scan_plain(cfg: tuple, args: tuple) -> tuple:
    """The classic scan in plain torch: the reference's 10 outputs, then
    the iteration count."""
    out = solve_scan_full_plain(cfg, args)
    return _scan_finals(out[:-1]) + (out[-1],)


def solve_scan_resume_plain(cfg: tuple, args: tuple, state: tuple, p_lo: int) -> tuple:
    """Continue `state` (written in place) with the suffix pods
    [p_lo, n_pods) enqueued; returns the state, then this call's iteration
    count."""
    _enqueue_suffix_plain(args, state, p_lo)
    _scan_loop_plain(cfg, args, state)
    return tuple(state) + (state[0][7],)


# -- kernel wrapper ------------------------------------------------------------

_scan_lib_cache: list = []

# the kernel's parameter block (csrc/scan.cu ScanParams)
_N_PTRS = 24 + 17 + 1  # operands (less claim_pad, n_pods, n_nodes), state, scratch
_N_DIMS = 20
_MODE_FULL, _MODE_RESUME = 0, 1
_DESIGNS = {"global": 0, "resident": 1}


def _scan_lib() -> ctypes.CDLL:
    if not _scan_lib_cache:
        lib = kernel_library("scan")
        lib.kt_solve_scan.restype = ctypes.c_int
        lib.kt_solve_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.kt_scan_resident_bytes.restype = ctypes.c_longlong
        lib.kt_scan_resident_bytes.argtypes = [ctypes.c_void_p]
        _scan_lib_cache.append(lib)
    return _scan_lib_cache[0]


def scan_resident_bytes_kernel(d: dict) -> int:
    """The kernel's own count of `scan_resident_bytes(d)` (builds the
    library), for the card checks that the two agree."""
    dims = (ctypes.c_int * 8)(*(int(d[k]) for k in ("C", "G", "U", "D", "T", "F", "I", "limits")))
    return int(_scan_lib().kt_scan_resident_bytes(dims))


def _check_scan_operands(cfg: tuple, args: tuple) -> None:
    if len(args) != SCAN_N_ARGS:
        raise ValueError(f"solve_scan takes {SCAN_N_ARGS} operands, got {len(args)}")
    T, has_nodes, has_limits = cfg
    dev = args[0].device
    for k, (t, (_, dt)) in enumerate(zip(args, SCAN_OPERANDS)):
        if t.device != dev:
            raise KernelError(f"solve_scan: operand {k} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise KernelError(f"solve_scan: operand {k} dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise KernelError(f"solve_scan: operand {k} not contiguous")
    d = _scan_dims(cfg, args)
    G, D, U, I = d["G"], d["D"], d["U"], args[17].shape[1]
    F = args[10].shape[0]
    if not 0 < T <= 8:
        raise KernelError(f"solve_scan: {T} templates, the kernel takes 1..8")
    expect = {
        2: (G, D), 3: (G, D), 5: (T, D), 6: (T, G), 7: (T, G), 8: (T, G), 9: (T, G, U),
        10: (F, G), 11: (F, G), 12: (T, F, U), 13: (), 14: (), 20: (U, I), 23: (T,),
    }
    if has_nodes:
        expect.update({15: (d["N"], G), 16: (d["N"], D)})
    if has_limits:
        L = d["L"]
        expect.update({18: (T, I), 19: (T, G, I), 21: (I,), 22: (I, D), 24: (L, D),
                       25: (L, D), 26: (L,)})
    for k, shape in expect.items():
        if tuple(args[k].shape) != shape:
            raise KernelError(f"solve_scan: operand {k} shape {tuple(args[k].shape)}, expected {shape}")
    if d["C"] >= 1 << 18 or d["Qcap"] >= 1 << 20:
        raise KernelError(f"solve_scan: C={d['C']} or queue {d['Qcap']} exceeds the int64 key packing")


def _alloc_state(cfg: tuple, args: tuple) -> tuple:
    dev = args[0].device
    return tuple(torch.empty(shape, dtype=dt, device=dev) for _, shape, dt in _state_spec(cfg, args))


def _launch_scan(cfg: tuple, args: tuple, state: tuple, mode: int, p_lo: int = 0,
                 design: Optional[str] = None, threads: int = SCAN_THREADS) -> str:
    """One kt_solve_scan launch: `_MODE_FULL` initializes `state` and runs
    the loop; `_MODE_RESUME` loads the scalars from state[0], enqueues the
    suffix [p_lo, n_pods) and runs the loop. Either writes `state` in
    place. `design` None takes `scan_design`'s; `threads` is the resident
    design's block size. Returns the design launched; a refused launch
    raises KernelError."""
    T, has_nodes, has_limits = cfg
    (
        pod_gi, claim_pad, g_req, g_floor, uniq_alloc, usage0, tol, open_ok,
        open_fam, open_uok, trans_kind, trans_fam, famu_ok, n_pods, n_nodes,
        node_ok, node_rem0, fam_mask, tmpl_mask, open_cand, uid_onehot,
        uid_of_type, cap_f, pool_of_t, pool_rem0, pool_has, pool_bad,
    ) = args
    dev = pod_gi.device
    d = _scan_dims(cfg, args)
    P, N = d["P"], d["N"]
    I = fam_mask.shape[1]
    WU = (d["U"] + 31) // 32
    n_pods_v, n_nodes_v = int(n_pods), int(n_nodes)
    if not 0 <= n_pods_v <= P or (has_nodes and not 0 <= n_nodes_v <= N):
        raise KernelError(f"solve_scan: n_pods={n_pods_v} / n_nodes={n_nodes_v} outside the operands")
    # scratch, rebuilt by every launch: uid_onehot's columns as U-bit words
    colw = torch.empty(I * WU if has_limits else 1, dtype=torch.int32, device=dev)
    ptrs = [
        pod_gi, g_req, g_floor, uniq_alloc, usage0, tol, open_ok, open_fam,
        open_uok, trans_kind, trans_fam, famu_ok, node_ok, node_rem0, fam_mask,
        tmpl_mask, open_cand, uid_onehot, uid_of_type, cap_f, pool_of_t,
        pool_rem0, pool_has, pool_bad, *state, colw,
    ]
    assert len(ptrs) == _N_PTRS
    if design is None:
        design = scan_design(cfg, args)
    dims = [P, d["G"], d["C"], d["U"], d["D"], trans_kind.shape[0], T, N, I, d["L"], d["Qcap"], WU,
            n_pods_v, n_nodes_v, int(bool(has_nodes)), int(bool(has_limits)), mode, int(p_lo),
            _DESIGNS[design], int(threads)]
    assert len(dims) == _N_DIMS
    ptr_arr = (ctypes.c_void_p * _N_PTRS)(*(t.data_ptr() for t in ptrs))
    dim_arr = (ctypes.c_int * _N_DIMS)(*dims)
    rc = launch(dev, _scan_lib().kt_solve_scan, ptr_arr, dim_arr)
    if rc != 0:
        raise KernelError(f"solve_scan: CUDA launch of the {design} design failed with cudaError {rc}")
    return design


def _solve_scan_full(cfg: tuple, args: tuple, name: str, design: Optional[str]) -> tuple:
    """One full-mode launch on fresh state, counted under `name` and its
    design; returns the state, then `steps`."""
    _check_scan_operands(cfg, args)
    state = _alloc_state(cfg, args)
    design = _launch_scan(cfg, args, state, _MODE_FULL, design=design)
    LAUNCHES[name] += 1
    LAUNCHES[f"scan_{design}"] += 1
    return state + (state[0][7],)


def solve_scan(cfg: tuple, args: tuple, _design: Optional[str] = None) -> tuple:
    """Run the fused scan (B14). cfg = (T, has_nodes, has_limits), the
    static variant; args = the 27 operands (convert.scan_operands_from_numpy).
    Returns (abort, nclaims, pod_claim, pod_node, pod_seq, claim_ti,
    claim_fam, u_valid, tm_st, pool_rem, steps). `_design` forces a kernel
    design ("global" or "resident"), for the card checks only; the design
    otherwise follows the dims (`scan_design`)."""
    if _on_cpu(args[0]):
        return solve_scan_plain(cfg, args)
    out = _solve_scan_full(cfg, args, "solve_scan", _design)
    return _scan_finals(out[:-1]) + (out[-1],)


def solve_scan_full(cfg: tuple, args: tuple, _design: Optional[str] = None) -> tuple:
    """The cold scan returning its full final state (B15): the
    SCAN_STATE_FIELDS tensors (`scal` then 16 tensors; the reference's 23
    components, convert.scan_state_to_numpy), then `steps`. `_design` as
    for solve_scan."""
    if _on_cpu(args[0]):
        return solve_scan_full_plain(cfg, args)
    return _solve_scan_full(cfg, args, "solve_scan_full", _design)


def solve_scan_resume(cfg: tuple, args: tuple, state: tuple, p_lo: int,
                      _design: Optional[str] = None) -> tuple:
    """Warm resume (B16): continue the scan from a resident final state
    with the suffix pods [p_lo, n_pods) enqueued. Sound ONLY under the
    residency eligibility contract (ops/delta.py). The state tensors are
    written in place — a warm pass allocates no new state. Returns the
    state, then this launch's `steps`. `_design` as for solve_scan."""
    if len(state) != len(SCAN_STATE_FIELDS):
        raise ValueError(f"solve_scan_resume takes {len(SCAN_STATE_FIELDS)} state tensors, got {len(state)}")
    if _on_cpu(args[0]):
        return solve_scan_resume_plain(cfg, args, state, p_lo)
    _check_scan_operands(cfg, args)
    dev = args[0].device
    for t, (name, shape, dt) in zip(state, _state_spec(cfg, args)):
        _check(f"solve_scan_resume state {name}", t, dt, shape, dev)
    design = _launch_scan(cfg, args, state, _MODE_RESUME, p_lo, design=_design)
    LAUNCHES["solve_scan_resume"] += 1
    LAUNCHES[f"scan_{design}"] += 1
    return tuple(state) + (state[0][7],)


# -- the mesh twins: replicated -------------------------------------------------


def replicate_scan(mesh, mode: str, cfg: tuple, args: tuple, states=None, p_lo: int = 0) -> list:
    """Run one scan variant on every shard of `mesh` — `mode` is
    "classic" (solve_scan), "full" (solve_scan_full) or "resume"
    (solve_scan_resume of states[s], written in place) — each on its own
    device under that device's current stream, on the 27 operands
    replicated there (one copy per distinct device). Returns every
    replica's outputs, in shard order; on the card each launch counts once
    under `sharded_solve_scan{,_full,_resume}`. Shards on a repeated device
    run one after the other, each on its own state."""
    name, fn = {
        "classic": ("sharded_solve_scan", solve_scan),
        "full": ("sharded_solve_scan_full", solve_scan_full),
        "resume": ("sharded_solve_scan_resume", solve_scan_resume),
    }[mode]
    if mode == "resume" and len(states) != mesh.size:
        raise ValueError(f"{len(states)} resident states for a {mesh.size}-device mesh")
    rep = [mesh_mod.per_shard(a, mesh) for a in args]
    outs = []
    for s, dev in enumerate(mesh.devices):
        shard_args = tuple(r[s] for r in rep)
        if mode == "resume":
            outs.append(fn(cfg, shard_args, states[s], p_lo))
        else:
            outs.append(fn(cfg, shard_args))
        if dev.type == "cuda":
            LAUNCHES[name] += 1
    return outs


def sharded_solve_scan(mesh):
    """The classic scan over a mesh (B17): a callable with solve_scan's
    signature. The scan is a sequential loop, so the mesh twin replicates
    it: every shard runs the same launch on replicated operands and shard
    0's outputs are returned (all replicas agree by construction)."""
    return lambda cfg, args: replicate_scan(mesh, "classic", cfg, args)[0]


def sharded_solve_scan_full(mesh):
    """The full-state scan over a mesh (B17): a callable (cfg, args) that
    returns every replica's `solve_scan_full` result, in shard order — the
    residency keeps one state per shard."""
    return lambda cfg, args: replicate_scan(mesh, "full", cfg, args)


def sharded_solve_scan_resume(mesh):
    """The warm resume over a mesh (B17): a callable (cfg, args, states,
    p_lo) resuming each shard's resident state in place on its own device
    (the counterpart of the reference's donated replicated buffers);
    returns every replica's result, in shard order."""
    return lambda cfg, args, states, p_lo: replicate_scan(mesh, "resume", cfg, args, states, p_lo)
