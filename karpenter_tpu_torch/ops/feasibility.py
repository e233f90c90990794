"""The feasibility sweep: batched requirement intersection on the card.

This is the CUDA replacement for the reference's hottest loop,
`filterInstanceTypesByRequirements` (pkg/controllers/provisioning/scheduling/
nodeclaim.go:373-441), factorized as:

    ReqCompat[R, I]  — every distinct Requirement row vs every instance type
    compat[P, I]     — AND over each entity's rows
    offering[P, I]   — any available offering compatible per instance

Set-intersection semantics mirror pkg/scheduling/requirement.go:194-228
(HasIntersection) and requirements.go:248-268 (Intersects: only shared keys
constrain; NotIn/DoesNotExist pairs are exempt).

Each public function is a wrapper: given CUDA tensors it checks them and
launches its hand-written kernel (csrc/feasibility.cu), given CPU tensors it
runs the plain torch version beside it, which mirrors the JAX program of
karpenter_tpu/ops/feasibility.py. There is no fallback from one to the
other. `LAUNCHES` counts kernel launches per kernel (never plain-version
calls). Bit masks are uint32 words held in int32 tensors (same bits).

The catalog engine's path has two entries of its own beside the JAX
signatures: `req_rows_vs_targets` (a row batch, one int32 row table,
against the types and the offerings in one kt_row_compat launch) and
`cube_rows` (the cube over the engine's resident row matrices, read by
index, in one kt_cube launch; the entity rows may be two column ranges of
one uploaded array).
The kernels read the catalog's constant tables packed (`pack_sets`,
`key_slot_words`, `cube_pack`); the packs are made here on a catalog's
first call and kept while their source tensors are the same objects,
unchanged in place (`_cached`).
"""

from __future__ import annotations

import ctypes
import weakref
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.device import KernelError, kernel_library, launch
from karpenter_tpu_torch.ops.encoding import NO_GT, NO_LT, NOT_INT, WORD

# kernel launches per kernel, counted where each wrapper launches
LAUNCHES: dict[str, int] = {
    "row_compat": 0, "membership": 0, "cube": 0, "uid_project": 0, "offering_reduce": 0,
    "fits_matrix": 0, "stage_plane": 0, "sharded_cube": 0,
}

_TILE = 32  # entities per kernel thread (csrc/feasibility.cu TILE)
_CUBE_THREADS = 128  # kt_cube's block: at most this many types a run (csrc CUBE_THREADS)
_MAX_GRID_Y = 65535
_MAX_SLABS = 64  # shards one launch covers on a card (csrc MAX_SLABS)
_MAX_SHARED_BYTES = 48 * 1024


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- plain torch versions ------------------------------------------------------


def unpack_mask(words: torch.Tensor) -> torch.Tensor:
    """[..., W] int32 words → [..., W*32] bool. The arithmetic shift of an
    int32 still leaves bit s in the low bit, so `& 1` extracts it."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD).bool()


def pack_words(bits: torch.Tensor) -> torch.Tensor:
    """[..., M] bool → [..., ceil(M / 32)] int32 words, bit b of word w
    bits[..., 32 w + b] (bits past M are 0): unpack_mask's inverse."""
    M = bits.shape[-1]
    W = (M + WORD - 1) // WORD
    lead = tuple(bits.shape[:-1])
    padded = torch.zeros(lead + (W * WORD,), dtype=torch.int64, device=bits.device)
    padded[..., :M] = bits
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    words = (padded.view(*lead, W, WORD) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _bounds_ok(gt, lt, value_int):
    """Per-slot integer-bounds admissibility (requirement.go:308-324)."""
    unbounded = (gt == NO_GT) & (lt == NO_LT)
    is_int = value_int != NOT_INT
    in_range = is_int & (value_int > gt) & (value_int < lt)
    return unbounded | in_range


def req_rows_vs_sets_plain(
    row_key, row_complement, row_has_values, row_gt, row_lt, row_mask,
    set_present, set_complement, set_has_values, set_gt, set_lt, set_mask,
    slot_key, value_int,
) -> torch.Tensor:
    """compat[R, N] in plain torch, mirroring the JAX req_rows_vs_sets."""
    key = row_key.long()
    present = set_present[:, key].T
    s_comp = set_complement[:, key].T
    s_hasv = set_has_values[:, key].T
    s_gt = set_gt[:, key].T
    s_lt = set_lt[:, key].T

    g = torch.maximum(row_gt[:, None], s_gt)
    l = torch.minimum(row_lt[:, None], s_lt)
    bounds_empty = (g != NO_GT) & (l != NO_LT) & (g >= l)
    both_complement = row_complement[:, None] & s_comp

    row_bits = unpack_mask(row_mask)  # [R, G]
    set_bits = unpack_mask(set_mask)  # [N, G]
    key_slots = slot_key[None, :] == row_key[:, None]  # [R, G]
    a_bits = torch.where(row_complement[:, None], ~row_bits, row_bits) & key_slots
    b_raw = set_bits[None, :, :]
    b_bits = torch.where(s_comp[:, :, None], ~b_raw, b_raw)  # [R, N, G]
    bounds = _bounds_ok(g[:, :, None], l[:, :, None], value_int[None, None, :])
    any_candidate = (a_bits[:, None, :] & b_bits & bounds).any(dim=-1)

    false = torch.zeros((), dtype=torch.bool, device=row_key.device)
    has_intersection = torch.where(
        bounds_empty, false, torch.where(both_complement, ~false, any_candidate)
    )
    row_exempt = (row_complement & row_has_values) | (~row_complement & ~row_has_values)
    set_exempt = (s_comp & s_hasv) | (~s_comp & ~s_hasv)
    exempt = row_exempt[:, None] & set_exempt
    return ~present | has_intersection | exempt


def membership_all_plain(membership: torch.Tensor, row_ok: torch.Tensor) -> torch.Tensor:
    """[P, N]: no row of p is incompatible with n. The JAX program counts
    bad rows with an f32 matmul and tests < 0.5; this is the same predicate
    as an exact any-reduce."""
    return ~(membership[:, :, None] & ~row_ok[None, :, :]).any(dim=1)


def offering_reduce_plain(
    membership, offer_compat, custom_need, key_present, available, offering_owner,
    num_instances: int,
) -> torch.Tensor:
    """has_offering[P, I] in plain torch, mirroring the JAX offering_reduce:
    the three offering gates, then the offering→type any-reduce by owner
    index instead of the one-hot matmul (each offering has exactly one
    owner). The has-offering half of the cube (production_cube_plain)."""
    offer_rows_ok = membership_all_plain(membership, offer_compat)  # [P, O]
    undef_ok = ~(custom_need[None, :, :] & ~key_present[:, None, :]).any(dim=-1)
    offer_ok = offer_rows_ok & undef_ok & available[None, :]
    counts = torch.zeros(
        (membership.shape[0], num_instances), dtype=torch.int32, device=membership.device
    )
    counts.index_add_(1, offering_owner.long(), offer_ok.to(torch.int32))
    return counts > 0


def production_cube_plain(
    membership, req_compat, offer_compat, custom_need, key_present, available,
    offering_owner,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(compat[P, I], has_offering[P, I]) in plain torch, mirroring the JAX
    _cube_math: the membership reduce and offering_reduce_plain."""
    compat = membership_all_plain(membership, req_compat)
    return compat, offering_reduce_plain(
        membership, offer_compat, custom_need, key_present, available, offering_owner,
        req_compat.shape[1],
    )


def cube_rows_plain(
    membership, key_present, rows, req_compat, offer_compat, custom_need, available,
    offering_owner,
) -> torch.Tensor:
    """cube_rows in plain torch: the rows `rows` of the resident matrices
    gathered, membership's first len(rows) columns, then
    production_cube_plain; the two planes stacked [2, P, I]."""
    R = rows.shape[0]
    idx = rows.long()
    compat, has = production_cube_plain(
        membership[:, :R], req_compat[idx], offer_compat[idx], custom_need, key_present,
        available, offering_owner,
    )
    return torch.stack((compat, has))


def req_rows_vs_targets_plain(rows, packs, key_slots, value_int) -> torch.Tensor:
    """req_rows_vs_targets in plain torch, from the tables the kernel
    reads: the row table's fields (row_fields), each target's sets
    unpacked (unpack_sets), the slot keys recovered from the key-slot
    words (slot_key_of), then req_rows_vs_sets_plain per target; [R, sum
    of N] in target order."""
    slot_key = slot_key_of(key_slots)
    fields = row_fields(rows)
    return torch.cat(
        [req_rows_vs_sets_plain(*fields, *unpack_sets(p), slot_key, value_int) for p in packs], dim=1
    )


def uid_project_plain(uid_onehot: torch.Tensor, type_mask: torch.Tensor) -> torch.Tensor:
    """[..., U]: does any type of `type_mask` map onto unique-allocatable
    row u? The JAX program counts surviving types with an f32 matmul and
    tests > 0.5; this is the same predicate as an exact any-reduce."""
    return (type_mask[..., None, :] & uid_onehot).any(dim=-1)


def uid_project_factored_plain(uid_onehot: torch.Tensor, tmpl_mask: torch.Tensor,
                               fam_mask: torch.Tensor) -> torch.Tensor:
    """[T, F, U]: uid_project_plain of the product mask tmpl_mask[:, None]
    & fam_mask[None], as the reference builds the fused scan's famu_ok."""
    return uid_project_plain(uid_onehot, tmpl_mask[:, None, :] & fam_mask[None, :, :])


def fits_matrix_plain(requests: torch.Tensor, allocatable: torch.Tensor) -> torch.Tensor:
    """fits[P, I] in plain torch, the JAX fits_matrix."""
    return (requests[:, None, :] <= allocatable[None, :, :]).all(dim=-1)


def stage_plane_plain(compat: torch.Tensor, fits: torch.Tensor, has_offering: torch.Tensor) -> torch.Tensor:
    """The uint8 stage codes in plain torch, the JAX stage_plane."""
    code = lambda c: torch.tensor(c, dtype=torch.uint8, device=compat.device)  # noqa: E731
    return torch.where(
        ~compat, code(STAGE_REQUIREMENTS),
        torch.where(~fits, code(STAGE_RESOURCES),
                    torch.where(~has_offering, code(STAGE_OFFERINGS), code(STAGE_OK))),
    )


def uid_onehot_matrix(uid_of_type: np.ndarray, num_uniq: int) -> np.ndarray:
    """[U, I] bool one-hot of uid_of_type — the projection operand
    uid_project consumes (built once per engine catalog)."""
    I = uid_of_type.shape[0]
    out = np.zeros((num_uniq, I), dtype=bool)
    out[uid_of_type, np.arange(I)] = True
    return out


# -- the kernels' packed tables -------------------------------------------------


ROW_FIELDS = 5  # row_table's columns before the mask words (csrc ROW_FIELDS)


def row_table(key, complement, has_values, gt, lt, mask):
    """A row batch as kt_row_compat reads it: [R, 5 + W] int32, per row its
    key, complement, has_values, gt and lt, then its mask words. numpy
    arrays give a numpy table (the engine builds it on the host and
    uploads it in one copy); tensors give a tensor on their device."""
    if isinstance(key, np.ndarray):
        R, W = mask.shape
        out = np.empty((R, ROW_FIELDS + W), dtype=np.int32)
        for c, field in enumerate((key, complement, has_values, gt, lt)):
            out[:, c] = field
        out[:, ROW_FIELDS:] = mask.view(np.int32) if mask.dtype == np.uint32 else mask
        return out
    return torch.cat([key[:, None], complement[:, None].int(), has_values[:, None].int(),
                      gt[:, None], lt[:, None], mask], dim=1)


def row_fields(rows: torch.Tensor) -> tuple:
    """row_table's inverse: the six row arrays of req_rows_vs_sets."""
    return (rows[:, 0], rows[:, 1].bool(), rows[:, 2].bool(), rows[:, 3], rows[:, 4],
            rows[:, ROW_FIELDS:])


@dataclass(eq=False)
class PackedSets:
    """One target's set side as kt_row_compat reads it: per (key, set) the
    flags present (bit 0), complement (bit 1) and has_values (bit 2) in one
    word, and gt, lt, all [K, N]; the mask words [W, N]. Sets along the
    minor axis, so consecutive threads read consecutive words. `ptrs`:
    the four tables' device addresses, read once."""

    flags: torch.Tensor  # [K, N] int32
    gt: torch.Tensor  # [K, N] int32
    lt: torch.Tensor  # [K, N] int32
    mask: torch.Tensor  # [W, N] int32 (uint32 words)

    def __post_init__(self):
        self.ptrs = tuple(_ptr(t) for t in (self.flags, self.gt, self.lt, self.mask))
        (self.K, self.N), self.W = self.flags.shape, self.mask.shape[0]


def pack_sets(present, complement, has_values, gt, lt, mask) -> PackedSets:
    """A target's [N, K] / [N, W] set arrays packed for kt_row_compat, on
    their device (a few torch ops, once per catalog encode)."""
    flags = present.int() | (complement.int() << 1) | (has_values.int() << 2)
    return PackedSets(flags.T.contiguous(), gt.T.contiguous(), lt.T.contiguous(), mask.T.contiguous())


def unpack_sets(p: PackedSets) -> tuple:
    """pack_sets' inverse: the six [N, K] / [N, W] set arrays."""
    return ((p.flags & 1).bool().T, (p.flags & 2).bool().T, (p.flags & 4).bool().T,
            p.gt.T, p.lt.T, p.mask.T)


def key_slot_words(slot_key: torch.Tensor, num_keys: int) -> torch.Tensor:
    """[K, W] int32: bit b of word w of row k set when slot 32 w + b belongs
    to key k (padding slots, slot_key -1, belong to none)."""
    keys = torch.arange(num_keys, dtype=slot_key.dtype, device=slot_key.device)
    return pack_words(slot_key[None, :] == keys[:, None])


def slot_key_of(key_slots: torch.Tensor) -> torch.Tensor:
    """key_slot_words' inverse: [G] int32, each slot's key, -1 for none."""
    bits = unpack_mask(key_slots)  # [K, G]
    if bits.shape[0] == 0:
        return torch.full((bits.shape[1],), -1, dtype=torch.int32, device=bits.device)
    owner = bits.int().argmax(dim=0).to(torch.int32)
    return torch.where(bits.any(dim=0), owner, torch.full_like(owner, -1))


@dataclass(eq=False)
class CubePack:
    """The catalog's constant tables as kt_cube reads them: custom_need as
    key words per offering [WK, O]; type i's offerings
    [type_start[i], type_start[i + 1]) (offerings are owner-major); the
    block plan, block b covering types [plan[b], plan[b + 1])."""

    need_words: torch.Tensor  # [WK, O] int32
    type_start: torch.Tensor  # [I + 1] int32
    plan: torch.Tensor  # [runs + 1] int32
    runs: int


def block_plan(type_start: np.ndarray, per_block: int = _CUBE_THREADS) -> np.ndarray:
    """kt_cube's block plan: the types cut into runs of consecutive types,
    each of at most `per_block` types and, unless one type alone has more,
    at most `per_block` offerings; the runs' first types and, last, the
    type count."""
    I = type_start.shape[0] - 1
    starts = [0]
    t = 0
    while t < I:
        end = t + 1
        while end < I and end - t < per_block and type_start[end + 1] - type_start[t] <= per_block:
            end += 1
        starts.append(end)
        t = end
    return np.asarray(starts, dtype=np.int32)


def cube_pack(custom_need: torch.Tensor, offering_owner: torch.Tensor, num_instances: int) -> CubePack:
    """kt_cube's packed catalog on the operands' device (once per catalog:
    the owners come to the host for the plan). Raises KernelError unless
    offerings are stored owner-major."""
    owner = offering_owner.cpu().numpy()
    if np.any(np.diff(owner) < 0):
        raise KernelError("cube: offerings must be stored owner-major (offering_owner non-decreasing)")
    type_start = np.searchsorted(owner, np.arange(num_instances + 1), side="left").astype(np.int32)
    plan = block_plan(type_start)
    dev = custom_need.device
    return CubePack(
        pack_words(custom_need).T.contiguous(), torch.from_numpy(type_start).to(dev),
        torch.from_numpy(plan).to(dev), plan.shape[0] - 1,
    )


# the packs of the last few catalogs: (the source tensors' weak references,
# the pack) by kind and the sources' (id, _version)
_PACK_KEEP = 16
_packs: OrderedDict = OrderedDict()


def _cached(kind: tuple, srcs: tuple, make):
    """The pack of `kind` made from `srcs`, made on first use and reused
    while every source is the same object, unchanged in place (its
    `_version`): a catalog that is encoded anew, or a vocabulary table
    uploaded anew, is a new tensor and packs anew."""
    key = kind + tuple((id(t), t._version) for t in srcs)
    hit = _packs.get(key)
    if hit is not None and all(ref() is t for ref, t in zip(hit[0], srcs)):
        _packs.move_to_end(key)
        return hit[1]
    value = make()
    _packs[key] = (tuple(weakref.ref(t) for t in srcs), value)
    while len(_packs) > _PACK_KEEP:
        _packs.popitem(last=False)
    return value


def _target_packs(targets) -> tuple:
    """The targets' PackedSets, one cache entry for all of them; each set
    array checked when it is packed."""
    srcs = tuple(a for t in targets for a in t)

    def make():
        packs = []
        for present, complement, has_values, gt, lt, mask in targets:
            dev = present.device
            N, K = present.shape
            W = mask.shape[1]
            for name, t, dt, shape in (
                ("set_present", present, torch.bool, (N, K)),
                ("set_complement", complement, torch.bool, (N, K)),
                ("set_has_values", has_values, torch.bool, (N, K)),
                ("set_gt", gt, torch.int32, (N, K)),
                ("set_lt", lt, torch.int32, (N, K)),
                ("set_mask", mask, torch.int32, (N, W)),
            ):
                _check(name, t, dt, shape, dev)
            packs.append(pack_sets(present, complement, has_values, gt, lt, mask))
        return tuple(packs)

    return _cached(("sets", len(targets)), srcs, make)


def _key_slots(slot_key: torch.Tensor, num_keys: int, num_words: int) -> torch.Tensor:
    """The key-slot words of a vocabulary table, once per table tensor; the
    table checked when it is packed."""
    def make():
        _check("slot_key", slot_key, torch.int32, (num_words * WORD,), slot_key.device)
        return key_slot_words(slot_key, num_keys)

    return _cached(("key_slots", num_keys), (slot_key,), make)


_identities: dict = {}  # (n, device) -> arange(n), int32


def _identity(n: int, dev: torch.device) -> torch.Tensor:
    """arange(n) as int32 on `dev`: the row index of a cube over all the
    rows given, made once per (n, device)."""
    t = _identities.get((n, dev))
    if t is None:
        t = _identities[(n, dev)] = torch.arange(n, dtype=torch.int32, device=dev)
    return t


# -- kernel wrappers -----------------------------------------------------------

_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = kernel_library("feasibility")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kt_row_compat.restype = ci
        lib.kt_row_compat.argtypes = [vp] * 5 + [ci] + [vp] * 4 + [ci] + [vp] * 3 + [ci] * 3 + [vp]
        lib.kt_membership.restype = ci
        lib.kt_membership.argtypes = [vp] * 3 + [ci] * 3 + [vp]
        lib.kt_cube.restype = ci
        lib.kt_cube.argtypes = [vp, ci, vp, ci, vp, ci, vp, vp, ci] + [vp] * 5 + [ci] + [vp] * 2 + [ci] * 4 + [vp]
        lib.kt_cube_fused.restype = ci
        lib.kt_cube_fused.argtypes = [vp, ci, vp, ci] + [vp] * 8 + [ci] * 5 + [vp]
        lib.kt_uid_project.restype = ci
        lib.kt_uid_project.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        lib.kt_noop.restype = ci
        lib.kt_noop.argtypes = [vp]
        for entry in (lib.kt_fits_matrix_f32, lib.kt_fits_matrix_i32):
            entry.restype = ci
            entry.argtypes = [vp] * 3 + [ci] * 3 + [vp]
        lib.kt_stage_plane.restype = ci
        lib.kt_stage_plane.argtypes = [vp] * 4 + [ctypes.c_longlong, vp]
        _lib_cache.append(lib)
    return _lib_cache[0]


def _on_cpu(first: torch.Tensor) -> bool:
    if first.is_cuda:
        return False
    if first.device.type == "cpu":
        return True
    raise ValueError(f"unsupported device {first.device}")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """A kernel's input contract; a breach is a KernelError like a failed
    launch, so the solve path never falls back past it. The common case,
    every test passing, costs four attribute reads and compares."""
    if t.dtype is not dtype or t.shape != shape or t.device != device or not t.is_contiguous():
        _refuse(name, t, dtype, shape, device)


def _refuse(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise KernelError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    raise KernelError(f"{name}: not contiguous")


def _check_rows(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    """_check for a bool matrix the kernel reads row by row with the row
    stride it is given: its columns adjacent, its rows at any stride (a
    column range of a wider array)."""
    if t.dtype is not torch.bool or t.shape != shape or t.device != device:
        _refuse(name, t, torch.bool, shape, device)
    if shape[1] > 1 and t.stride(1) != 1:
        raise KernelError(f"{name}: columns not adjacent (strides {t.stride()})")


def _ptr(t: torch.Tensor) -> int:
    """A tensor's device address for an entry point's c_void_p argument."""
    return t.data_ptr()


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise KernelError(f"{kernel}: CUDA launch failed with cudaError {rc}")


def req_rows_vs_sets(
    row_key: torch.Tensor,  # [R] int32
    row_complement: torch.Tensor,  # [R] bool
    row_has_values: torch.Tensor,  # [R] bool
    row_gt: torch.Tensor,  # [R] int32
    row_lt: torch.Tensor,  # [R] int32
    row_mask: torch.Tensor,  # [R, W] int32 (uint32 words)
    set_present: torch.Tensor,  # [N, K] bool
    set_complement: torch.Tensor,  # [N, K] bool
    set_has_values: torch.Tensor,  # [N, K] bool
    set_gt: torch.Tensor,  # [N, K] int32
    set_lt: torch.Tensor,  # [N, K] int32
    set_mask: torch.Tensor,  # [N, W] int32 (uint32 words)
    slot_key: torch.Tensor,  # [G = 32 W] int32
    value_int: torch.Tensor,  # [G] int32
) -> torch.Tensor:
    """compat[R, N]: does requirement row r intersect set n on r's key?

    Mirrors Intersects() semantics: a key the set doesn't constrain is
    compatible; NotIn/DoesNotExist on both sides is exempt from the
    intersection test."""
    args = (
        row_key, row_complement, row_has_values, row_gt, row_lt, row_mask,
        set_present, set_complement, set_has_values, set_gt, set_lt, set_mask,
        slot_key, value_int,
    )
    if _on_cpu(row_key):
        return req_rows_vs_sets_plain(*args)
    dev = row_key.device
    R, W = row_mask.shape
    i32, b = torch.int32, torch.bool
    for name, t, dt, shape in (
        ("row_key", row_key, i32, (R,)),
        ("row_complement", row_complement, b, (R,)),
        ("row_has_values", row_has_values, b, (R,)),
        ("row_gt", row_gt, i32, (R,)),
        ("row_lt", row_lt, i32, (R,)),
        ("row_mask", row_mask, i32, (R, W)),
    ):
        _check(name, t, dt, shape, dev)
    # the row table built on the card (a few device operations: this
    # signature is the reference's, no path of the engine calls it)
    return _row_compat_launch(row_table(*args[:6]), _target_packs((args[6:12],)), slot_key, value_int)


def req_rows_vs_targets(
    rows: torch.Tensor,  # [R, 5 + W] int32: row_table of the batch
    targets,  # one or two (present, complement, has_values, gt, lt, mask) set tuples
    slot_key: torch.Tensor,  # [G = 32 W] int32
    value_int: torch.Tensor,  # [G] int32
) -> torch.Tensor:
    """compat[R, N_0 + N_1]: req_rows_vs_sets of a row batch (its
    row_table, one upload) against each target (the catalog engine's
    types, then its offerings), side by side, in one kt_row_compat launch.
    The targets' sets, and the key-slot words of slot_key, are packed on
    their first call and kept (_cached); the plain version unpacks those
    packs, so the CPU runs the same layout."""
    if not 1 <= len(targets) <= 2:
        raise ValueError(f"req_rows_vs_targets: {len(targets)} targets, expected 1 or 2")
    packs = _target_packs(targets)  # referenced until the launch is queued
    if _on_cpu(rows):
        K, W = packs[0].K, rows.shape[1] - ROW_FIELDS
        return req_rows_vs_targets_plain(rows, packs, _key_slots(slot_key, K, W), value_int)
    return _row_compat_launch(rows, packs, slot_key, value_int)


def _row_compat_launch(rows, packs, slot_key, value_int) -> torch.Tensor:
    """Check the row table and launch kt_row_compat over one or two packed
    targets; counted under `row_compat`."""
    dev = rows.device
    R, C = rows.shape
    W = C - ROW_FIELDS
    K = packs[0].K
    _check("rows", rows, torch.int32, (R, C), dev)
    _check("value_int", value_int, torch.int32, (W * WORD,), dev)
    for p in packs:
        if p.K != K or p.W != W or p.flags.device != dev:
            raise KernelError(f"row_compat: a target's sets are [{p.K} keys, {p.W} words] on "
                              f"{p.flags.device}, expected [{K}, {W}] on {dev}")
    if W < 0 or W * 4 > _MAX_SHARED_BYTES:
        raise KernelError(f"row_compat: {W} mask words for the kernel's shared memory")
    key_slots = _key_slots(slot_key, K, W)
    N = sum(p.N for p in packs)
    out = torch.empty((R, N), dtype=torch.bool, device=dev)
    second = packs[1].ptrs + (packs[1].N,) if len(packs) == 2 else (None,) * 4 + (0,)
    rc = launch(dev, _lib().kt_row_compat, _ptr(rows), *packs[0].ptrs, packs[0].N, *second,
                _ptr(key_slots), _ptr(value_int), _ptr(out), N, R, W)
    _raise_on(rc, "row_compat")
    LAUNCHES["row_compat"] += bool(R and N)  # empty inputs launch nothing
    return out


def _membership_kernel(membership: torch.Tensor, row_ok: torch.Tensor) -> torch.Tensor:
    dev = membership.device
    P, R = membership.shape
    N = row_ok.shape[1]
    _check("membership", membership, torch.bool, (P, R), dev)
    _check("row_ok", row_ok, torch.bool, (R, N), dev)
    if (P + _TILE - 1) // _TILE > _MAX_GRID_Y:
        raise KernelError(f"membership: {P} entities exceed the kernel's grid")
    out = torch.empty((P, N), dtype=torch.bool, device=dev)
    rc = launch(dev, _lib().kt_membership, _ptr(membership), _ptr(row_ok), _ptr(out), P, R, N)
    _raise_on(rc, "membership")
    LAUNCHES["membership"] += bool(P and N)
    return out


def membership_all(membership: torch.Tensor, row_ok: torch.Tensor) -> torch.Tensor:
    """all-rows-compatible.

    membership: [P, R] bool — entity p constrained by requirement row r
    row_ok:     [R, N] bool — row r compatible with target n
    returns     [P, N] bool — every row of p compatible with n
    """
    if _on_cpu(membership):
        return membership_all_plain(membership, row_ok)
    return _membership_kernel(membership, row_ok)


def _cube_launch(
    name: str, membership, key_present, rows, req_compat, offer_compat, custom_need, available,
    offering_owner, num_instances: int,
) -> torch.Tensor:
    """Check the cube's inputs and launch kt_cube: [2, P, I] (compat,
    has_offering), or with req_compat None the has_offering plane alone,
    [1, P, I]. Membership column r reads matrix row rows[r]; columns past
    len(rows) are padding. Counted under `name`."""
    dev = membership.device
    P, Rm = membership.shape
    R = rows.shape[0]
    Rtot, O = offer_compat.shape
    K = custom_need.shape[1]
    I = num_instances
    _check_rows("membership", membership, (P, Rm), dev)
    _check_rows("key_present", key_present, (P, K), dev)
    _check("rows", rows, torch.int32, (R,), dev)
    if req_compat is not None:
        _check("req_compat", req_compat, torch.bool, (Rtot, I), dev)
    _check("offer_compat", offer_compat, torch.bool, (Rtot, O), dev)
    _check("custom_need", custom_need, torch.bool, (O, K), dev)
    _check("available", available, torch.bool, (O,), dev)
    _check("offering_owner", offering_owner, torch.int32, (O,), dev)
    if R > Rm:
        raise KernelError(f"{name}: {R} rows for {Rm} membership columns")
    if (2 * R + K + (K + 31) // 32) * 4 > _MAX_SHARED_BYTES:
        raise KernelError(f"{name}: {R} rows x {K} keys exceed the kernel's shared memory")
    if (P + _TILE - 1) // _TILE > _MAX_GRID_Y:
        raise KernelError(f"{name}: {P} entities exceed the kernel's grid")
    # the pack stays referenced until the launch is queued
    pack = _cached(("cube", I), (custom_need, offering_owner),
                   lambda: cube_pack(custom_need, offering_owner, I))
    planes = 1 if req_compat is None else 2
    out = torch.empty((planes, P, I), dtype=torch.bool, device=dev)
    base = _ptr(out)
    rc = launch(
        dev, _lib().kt_cube, _ptr(membership), membership.stride(0), _ptr(key_present),
        key_present.stride(0), _ptr(rows), R,
        None if req_compat is None else _ptr(req_compat), _ptr(offer_compat), Rtot,
        _ptr(pack.need_words), _ptr(available), _ptr(offering_owner), _ptr(pack.type_start),
        _ptr(pack.plan), pack.runs, None if req_compat is None else base, base + (planes - 1) * P * I,
        P, O, K, I,
    )
    _raise_on(rc, name)
    LAUNCHES[name] += bool(P and pack.runs)
    return out


def production_cube(
    membership: torch.Tensor,  # [P, R] bool
    req_compat: torch.Tensor,  # [R, I] bool
    offer_compat: torch.Tensor,  # [R, O] bool
    custom_need: torch.Tensor,  # [O, K] bool
    key_present: torch.Tensor,  # [P, K] bool
    available: torch.Tensor,  # [O] bool
    offering_owner: torch.Tensor,  # [O] int32, non-decreasing
) -> tuple[torch.Tensor, torch.Tensor]:
    """compat[P, I] and has_offering[P, I] — the production feasibility
    cube. On the card one kt_cube launch over every row given (an identity
    row index, made once per row count). The kernel requires offerings
    stored owner-major (offering_owner non-decreasing), which
    CatalogEngine guarantees."""
    if _on_cpu(membership):
        return production_cube_plain(
            membership, req_compat, offer_compat, custom_need, key_present,
            available, offering_owner,
        )
    rows = _identity(membership.shape[1], membership.device)
    out = _cube_launch("cube", membership, key_present, rows, req_compat, offer_compat,
                       custom_need, available, offering_owner, req_compat.shape[1])
    return out[0], out[1]


def cube_rows(
    membership: torch.Tensor,  # [P, Rm] bool, Rm >= R: columns past R are padding
    key_present: torch.Tensor,  # [P, K] bool
    rows: torch.Tensor,  # [R] int32: membership column r is matrix row rows[r]
    req_compat: torch.Tensor,  # [Rtot, I] bool, every interned row
    offer_compat: torch.Tensor,  # [Rtot, O] bool
    custom_need: torch.Tensor,  # [O, K] bool
    available: torch.Tensor,  # [O] bool
    offering_owner: torch.Tensor,  # [O] int32, non-decreasing
) -> torch.Tensor:
    """[2, P, I] bool: production_cube over the rows `rows` of the catalog
    engine's resident row matrices, read in place by index (the sweep's
    gather never runs), both planes in one buffer for one copy back.
    membership and key_present may be column ranges of one array (their
    rows at a stride: the engine uploads both in one copy). Row ids must
    lie in [0, Rtot); the kernel reads nothing for one that does not, where
    the plain version raises."""
    if _on_cpu(membership):
        return cube_rows_plain(membership, key_present, rows, req_compat, offer_compat,
                               custom_need, available, offering_owner)
    return _cube_launch("cube", membership, key_present, rows, req_compat, offer_compat,
                        custom_need, available, offering_owner, req_compat.shape[1])


def offering_reduce(
    membership: torch.Tensor,  # [P, R] bool
    offer_compat: torch.Tensor,  # [R, O] bool — row r compatible with offering o
    custom_need: torch.Tensor,  # [O, K] bool — offering needs custom key k defined
    key_present: torch.Tensor,  # [P, K] bool — query set defines key k
    available: torch.Tensor,  # [O] bool
    offering_owner: torch.Tensor,  # [O] int32, non-decreasing
    num_instances: int,
) -> torch.Tensor:
    """has_offering[P, I]: any available, fully-compatible offering per type
    (scheduling/nodeclaim.go:414-433 semantics) — the group solver's B8.
    Takes owner indices where the JAX program takes the [O, I] one-hot
    (offerings owner-major, as production_cube). On the card it launches
    the cube's kernel, kt_cube, with no compat plane, counted here as
    `offering_reduce`."""
    if _on_cpu(membership):
        return offering_reduce_plain(
            membership, offer_compat, custom_need, key_present, available,
            offering_owner, num_instances,
        )
    rows = _identity(membership.shape[1], membership.device)
    return _cube_launch("offering_reduce", membership, key_present, rows, None, offer_compat,
                        custom_need, available, offering_owner, num_instances)[0]


def uid_project(uid_onehot: torch.Tensor, type_mask: torch.Tensor) -> torch.Tensor:
    """surviving-unique-alloc projection: does ANY instance type in
    `type_mask` map onto unique-allocatable row u? (B6, the reference's
    signature; the fused scan's famu_ok comes from uid_project_factored,
    the same kernel, and the scan kernel projects its own masks in place,
    csrc/scan.cu.)

    uid_onehot: [U, I] bool — uid_of_type scattered one-hot
    type_mask:  [..., I] bool
    returns     [..., U] bool
    """
    if _on_cpu(uid_onehot):
        return uid_project_plain(uid_onehot, type_mask)
    U, I = uid_onehot.shape
    lead = tuple(type_mask.shape[:-1])
    _check("type_mask", type_mask, torch.bool, lead + (I,), uid_onehot.device)
    return _uid_launch(uid_onehot, type_mask.view(-1, I), None, lead + (U,))


def uid_project_factored(uid_onehot: torch.Tensor, tmpl_mask: torch.Tensor,
                         fam_mask: torch.Tensor) -> torch.Tensor:
    """The fused scan's famu_ok (ops/fused.py): does any instance type of
    template t AND family f map onto unique-allocatable row u? uid_project
    of tmpl_mask[:, None] & fam_mask[None], the product never built: on the
    card one kt_uid_project launch reads both masks as they are.

    uid_onehot: [U, I] bool; tmpl_mask: [T, I] bool; fam_mask: [F, I] bool
    returns     [T, F, U] bool
    """
    if _on_cpu(uid_onehot):
        return uid_project_factored_plain(uid_onehot, tmpl_mask, fam_mask)
    T, F, U = tmpl_mask.shape[0], fam_mask.shape[0], uid_onehot.shape[0]
    if F == 0:
        return torch.empty((T, 0, U), dtype=torch.bool, device=uid_onehot.device)
    return _uid_launch(uid_onehot, tmpl_mask, fam_mask, (T, F, U))


def _uid_launch(uid_onehot, tmpl_mask, fam_mask, shape: tuple) -> torch.Tensor:
    """One kt_uid_project launch into a new bool tensor of `shape`, laid out
    [T, F, U]: the rows of tmpl_mask [T, I] ANDed with those of fam_mask
    [F, I] (None: [T, U] from tmpl_mask alone)."""
    dev = uid_onehot.device
    U, I = uid_onehot.shape
    T = tmpl_mask.shape[0]
    _check("uid_onehot", uid_onehot, torch.bool, (U, I), dev)
    _check("tmpl_mask", tmpl_mask, torch.bool, (T, I), dev)
    F = 0
    if fam_mask is not None:
        F = fam_mask.shape[0]
        _check("fam_mask", fam_mask, torch.bool, (F, I), dev)
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    rc = launch(dev, _lib().kt_uid_project, _ptr(uid_onehot), _ptr(tmpl_mask),
                None if fam_mask is None else _ptr(fam_mask), _ptr(out), T, F, U, I)
    _raise_on(rc, "uid_project")
    LAUNCHES["uid_project"] += bool(T and U)
    return out


def fits_matrix(requests: torch.Tensor, allocatable: torch.Tensor) -> torch.Tensor:
    """fits[P, I]: requests[p] <= allocatable[i] element-wise (B4).

    requests:    [P, D] float32 or int32 (missing resources must be 0)
    allocatable: [I, D] the same dtype (resources the node lacks must be 0)
    Mirrors resources.Fits: a positive request against a zero capacity
    fails. The exact path passes integer-quantized units
    (quantize_resources); float32 alone loses ~512B at 8GiB scale."""
    if _on_cpu(requests):
        return fits_matrix_plain(requests, allocatable)
    dev = requests.device
    entry = {torch.float32: "kt_fits_matrix_f32", torch.int32: "kt_fits_matrix_i32"}.get(requests.dtype)
    if entry is None:
        raise KernelError(f"fits_matrix: dtype {requests.dtype}, expected float32 or int32")
    P, D = requests.shape
    I = allocatable.shape[0]
    _check("requests", requests, requests.dtype, (P, D), dev)
    _check("allocatable", allocatable, requests.dtype, (I, D), dev)
    out = torch.empty((P, I), dtype=torch.bool, device=dev)
    rc = launch(dev, getattr(_lib(), entry), _ptr(requests), _ptr(allocatable), _ptr(out), P, I, D)
    _raise_on(rc, "fits_matrix")
    LAUNCHES["fits_matrix"] += bool(P and I)
    return out


def stage_plane(compat: torch.Tensor, fits: torch.Tensor, has_offering: torch.Tensor) -> torch.Tensor:
    """[..., I] uint8 first-failing-stage codes from the cube's three bool
    planes of one shape (B7): requirements, then resources, then offerings;
    0 where the pair survived. The serving path decodes host-side
    (`stage_plane_np`); this is the device twin."""
    if _on_cpu(compat):
        return stage_plane_plain(compat, fits, has_offering)
    dev = compat.device
    shape = tuple(compat.shape)
    for name, t in (("compat", compat), ("fits", fits), ("has_offering", has_offering)):
        _check(name, t, torch.bool, shape, dev)
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    n = compat.numel()
    rc = launch(dev, _lib().kt_stage_plane, _ptr(compat), _ptr(fits), _ptr(has_offering), _ptr(out), n)
    _raise_on(rc, "stage_plane")
    LAUNCHES["stage_plane"] += bool(n)
    return out


# -- the mesh twin of the cube -------------------------------------------------


def mesh_scope(mesh) -> str:
    """The scope string of a mesh: device count + axis names (the
    reference's AOT table/cache scope, in its format)."""
    return f"mesh={mesh.size}:{','.join(mesh.axis_names)}"


def sharded_cube(mesh):
    """The production cube over a mesh (B5), a callable with
    production_cube's signature: the entity axis (membership, key_present)
    splits into one equal row slab per shard, the catalog operands are
    replicated (one copy per distinct device; an operand may also come as
    the per-shard tuple an engine caches), and the two planes are gathered
    in shard order on the first shard's device. No collective: the
    reference's shard_map has none until results gather. The entity axis
    must be a multiple of the mesh size (CatalogEngine pads it to
    mesh_multiple(n)).

    On a CUDA mesh, one launch of kt_cube_fused per card covers every
    shard the card holds (`_sharded_cube_cuda`), counted once per card
    under `sharded_cube`. On a CPU mesh each shard runs
    production_cube_plain on its own slab."""
    from karpenter_tpu_torch import mesh as mesh_mod

    def run(membership, req_compat, offer_compat, custom_need, key_present, available,
            offering_owner):
        if mesh.devices[0].type == "cuda":
            return _sharded_cube_cuda(mesh, membership, req_compat, offer_compat, custom_need,
                                      key_present, available, offering_owner)
        mem_s = mesh_mod.split_rows(membership, mesh)
        kp_s = mesh_mod.split_rows(key_present, mesh)
        rep = [mesh_mod.per_shard(x, mesh) for x in (
            req_compat, offer_compat, custom_need, available, offering_owner)]
        compat, offer = [], []
        for s in range(mesh.size):
            rc, oc, cn, av, ow = (r[s] for r in rep)
            c, o = production_cube(mem_s[s], rc, oc, cn, kp_s[s], av, ow)
            compat.append(c)
            offer.append(o)
        return mesh_mod.gather_rows(compat, mesh), mesh_mod.gather_rows(offer, mesh)

    return run


def slab_table(starts, slabs, dsts):
    """The kernels' slab table for one card: a (src, rows, dst) int triple
    per shard, as a ctypes array the C entry point copies into the
    launch's parameters."""
    flat = []
    for start, (_, lo, hi), dst in zip(starts, slabs, dsts):
        flat += (start, hi - lo, dst)
    return (ctypes.c_int * len(flat))(*flat)


def _sharded_cube_cuda(mesh, membership, req_compat, offer_compat, custom_need, key_present,
                       available, offering_owner):
    """sharded_cube on the card: the entity operands checked in one pass
    (host or device tensors, both on one device), the replicated catalog
    as mesh.Replicas (one copy of each checked: they are alike by
    construction); per card one upload of its entity rows
    (mesh.stage_rows), its output allocated once (card 0's is the gathered
    planes themselves) and one kt_cube_fused launch over its shards; every
    card's launch is queued before the gather (mesh.gather_cards) copies
    the other cards' rows over."""
    from karpenter_tpu_torch import mesh as mesh_mod

    rc, oc, cn, av, ow = (mesh_mod.per_shard(x, mesh) for x in (
        req_compat, offer_compat, custom_need, available, offering_owner))
    P, R = membership.shape
    I = rc[0].shape[1]
    O, K = cn[0].shape
    src = membership.device
    _check("membership", membership, torch.bool, (P, R), src)
    _check("key_present", key_present, torch.bool, (P, K), src)
    _check("req_compat", rc[0], torch.bool, (R, I), rc[0].device)
    _check("offer_compat", oc[0], torch.bool, (R, O), oc[0].device)
    _check("custom_need", cn[0], torch.bool, (O, K), cn[0].device)
    _check("available", av[0], torch.bool, (O,), av[0].device)
    _check("offering_owner", ow[0], torch.int32, (O,), ow[0].device)
    if (R + K) * 4 > _MAX_SHARED_BYTES:
        raise KernelError(f"sharded_cube: {R} rows x {K} keys exceed the kernel's shared memory")
    plan = mesh_mod.slab_plan(mesh.devices, P)
    m = P // mesh.size
    if max(len(slabs) for _, slabs in plan) > _MAX_SLABS or -(-m // _TILE) > _MAX_GRID_Y:
        raise KernelError(f"sharded_cube: {mesh.size} shards of {P} entities exceed the kernel's grid")
    dev0 = mesh.devices[0]
    compat = torch.empty((P, I), dtype=torch.bool, device=dev0)
    offer = torch.empty((P, I), dtype=torch.bool, device=dev0)
    if P == 0 or I == 0:
        return compat, offer
    others = []
    for dev, slabs in plan:
        s = slabs[0][0]  # a shard on this card, for its catalog copies
        # `keep` holds staged rows until their launch is queued
        (mem_p, kp_p), starts, keep = mesh_mod.stage_rows((membership, key_present), slabs, dev)
        if dev == dev0:
            c, o, dsts = compat, offer, [lo for _, lo, _ in slabs]
        else:
            c = torch.empty((len(slabs) * m, I), dtype=torch.bool, device=dev)
            o = torch.empty_like(c)
            dsts = [k * m for k in range(len(slabs))]  # compact: the card's shards in order
            others.append((slabs, c, o))
        table = slab_table(starts, slabs, dsts)
        err = launch(
            dev, _lib().kt_cube_fused, ctypes.c_void_p(mem_p), R, ctypes.c_void_p(kp_p), K,
            _ptr(rc[s]), _ptr(oc[s]), _ptr(cn[s]), _ptr(av[s]), _ptr(ow[s]), _ptr(c), _ptr(o), table,
            len(slabs), R, O, K, I,
        )
        _raise_on(err, "sharded_cube")
        LAUNCHES["sharded_cube"] += 1
    mesh_mod.gather_cards(compat, [(slabs, c) for slabs, c, _ in others])
    mesh_mod.gather_cards(offer, [(slabs, o) for slabs, _, o in others])
    return compat, offer


# -- resource quantization (the group solver's integer units) ------------------

_BYTE_SCALE_PREFIXES = ("memory", "ephemeral-storage", "hugepages-")


def resource_scales(dims: dict[str, int]) -> np.ndarray:
    """Per-dimension quantization multipliers keeping values in int32 range:
    byte-denominated resources quantize to MiB, everything else to
    milli-units (cpu "100m" stays exact; 2 PiB memory still fits int32)."""
    scales = np.full(len(dims), 1000.0)
    for name, i in dims.items():
        if name.startswith(_BYTE_SCALE_PREFIXES):
            scales[i] = 1.0 / float(2**20)
    return scales


def quantize_resources(
    values: np.ndarray, ceil: bool, scales: np.ndarray | float = 1000.0
) -> np.ndarray:
    """float64 [., D] resources → int32-safe integer units, rounded
    conservatively: requests round up, capacities round down, so the integer
    comparison can only be stricter than the float64 host oracle, never
    looser. Saturation is asymmetric for the same reason — an oversized
    request clips ABOVE any clipped capacity, so it can never falsely fit."""
    scaled = values * scales
    if ceil:
        out = np.ceil(scaled - 1e-6)
        return np.clip(out, -(2**31) + 1, 2**31 - 1).astype(np.int64)
    out = np.floor(scaled + 1e-6)
    return np.clip(out, -(2**31) + 1, 2**30).astype(np.int64)


# -- decision provenance (observability/explain.py) ----------------------------
#
# One uint8 code per (entity, instance-type) naming the FIRST stage that
# eliminated the pair, in funnel order (requirements -> resources ->
# offerings; 0 = survived). Decoded host-side over the fetched bool planes.

STAGE_OK = 0
STAGE_REQUIREMENTS = 1
STAGE_RESOURCES = 2
STAGE_OFFERINGS = 3
STAGE_NAMES = {
    STAGE_REQUIREMENTS: "requirements",
    STAGE_RESOURCES: "resources",
    STAGE_OFFERINGS: "offerings",
}


def stage_plane_np(
    compat: np.ndarray, fits: np.ndarray, has_offering: np.ndarray
) -> np.ndarray:
    """[..., I] uint8 first-failing-stage codes from the cube's planes."""
    return np.where(
        ~compat,
        np.uint8(STAGE_REQUIREMENTS),
        np.where(
            ~fits,
            np.uint8(STAGE_RESOURCES),
            np.where(
                ~has_offering, np.uint8(STAGE_OFFERINGS), np.uint8(STAGE_OK)
            ),
        ),
    ).astype(np.uint8)


def stage_counts(plane: np.ndarray) -> dict[str, int]:
    """Decode a stage plane into per-stage elimination counts (survivors
    excluded) — the interned-vocabulary form the explain ledger records."""
    counts = np.bincount(np.asarray(plane, dtype=np.uint8).ravel(), minlength=4)
    return {
        name: int(counts[code])
        for code, name in STAGE_NAMES.items()
        if counts[code]
    }
