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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from karpenter_tpu_torch.device import KernelError, kernel_library, stream_handle
from karpenter_tpu_torch.ops.encoding import NO_GT, NO_LT, NOT_INT, WORD

# kernel launches per kernel, counted where each wrapper launches
LAUNCHES: dict[str, int] = {"row_compat": 0, "membership": 0, "cube": 0}

_TILE = 32  # entities per kernel thread (csrc/feasibility.cu TILE)
_MAX_GRID_Y = 65535
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


def production_cube_plain(
    membership, req_compat, offer_compat, custom_need, key_present, available,
    offering_owner,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(compat[P, I], has_offering[P, I]) in plain torch, mirroring the JAX
    _cube_math. The offering→type any-reduce goes by owner index instead of
    the one-hot matmul (each offering has exactly one owner)."""
    compat = membership_all_plain(membership, req_compat)
    offer_rows_ok = membership_all_plain(membership, offer_compat)  # [P, O]
    undef_ok = ~(custom_need[None, :, :] & ~key_present[:, None, :]).any(dim=-1)
    offer_ok = offer_rows_ok & undef_ok & available[None, :]
    P, I = membership.shape[0], req_compat.shape[1]
    counts = torch.zeros((P, I), dtype=torch.int32, device=membership.device)
    counts.index_add_(1, offering_owner.long(), offer_ok.to(torch.int32))
    return compat, counts > 0


# -- kernel wrappers -----------------------------------------------------------

_lib_cache: list = []


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = kernel_library("feasibility")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kt_row_compat.restype = ci
        lib.kt_row_compat.argtypes = [vp] * 15 + [ci] * 4 + [vp]
        lib.kt_membership.restype = ci
        lib.kt_membership.argtypes = [vp] * 3 + [ci] * 3 + [vp]
        lib.kt_cube_offer.restype = ci
        lib.kt_cube_offer.argtypes = [vp] * 7 + [ci] * 5 + [vp]
        _lib_cache.append(lib)
    return _lib_cache[0]


def _on_cpu(first: torch.Tensor) -> bool:
    if first.device.type == "cpu":
        return True
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    return False


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """A kernel's input contract; a breach is a KernelError like a failed
    launch, so the solve path never falls back past it."""
    if t.device != device:
        raise KernelError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise KernelError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise KernelError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise KernelError(f"{name}: not contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


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
    N, K = set_present.shape
    i32, b = torch.int32, torch.bool
    for name, t, dt, shape in (
        ("row_key", row_key, i32, (R,)),
        ("row_complement", row_complement, b, (R,)),
        ("row_has_values", row_has_values, b, (R,)),
        ("row_gt", row_gt, i32, (R,)),
        ("row_lt", row_lt, i32, (R,)),
        ("row_mask", row_mask, i32, (R, W)),
        ("set_present", set_present, b, (N, K)),
        ("set_complement", set_complement, b, (N, K)),
        ("set_has_values", set_has_values, b, (N, K)),
        ("set_gt", set_gt, i32, (N, K)),
        ("set_lt", set_lt, i32, (N, K)),
        ("set_mask", set_mask, i32, (N, W)),
        ("slot_key", slot_key, i32, (W * WORD,)),
        ("value_int", value_int, i32, (W * WORD,)),
    ):
        _check(name, t, dt, shape, dev)
    if W * 4 > _MAX_SHARED_BYTES:
        raise KernelError(f"row_compat: {W} mask words exceed the kernel's shared memory")
    out = torch.empty((R, N), dtype=torch.bool, device=dev)
    rc = _lib().kt_row_compat(
        *(_ptr(t) for t in args), _ptr(out), R, N, K, W, stream_handle(dev)
    )
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
    rc = _lib().kt_membership(_ptr(membership), _ptr(row_ok), _ptr(out), P, R, N, stream_handle(dev))
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
    cube. On the card: the membership kernel for the compat half, then the
    offering kernel (kt_cube_offer) for the offering half. The offering
    kernel requires offerings stored owner-major (offering_owner
    non-decreasing), which CatalogEngine guarantees."""
    if _on_cpu(membership):
        return production_cube_plain(
            membership, req_compat, offer_compat, custom_need, key_present,
            available, offering_owner,
        )
    dev = membership.device
    P, R = membership.shape
    I = req_compat.shape[1]
    O, K = custom_need.shape
    _check("offer_compat", offer_compat, torch.bool, (R, O), dev)
    _check("key_present", key_present, torch.bool, (P, K), dev)
    _check("available", available, torch.bool, (O,), dev)
    _check("offering_owner", offering_owner, torch.int32, (O,), dev)
    _check("custom_need", custom_need, torch.bool, (O, K), dev)
    shmem = _TILE * ((R + 31) // 32 + (K + 31) // 32) * 4
    if shmem > _MAX_SHARED_BYTES:
        raise KernelError(f"cube: {R} rows x {K} keys exceed the kernel's shared memory")
    compat = _membership_kernel(membership, req_compat)
    has_offering = torch.empty((P, I), dtype=torch.bool, device=dev)
    rc = _lib().kt_cube_offer(
        _ptr(membership), _ptr(offer_compat), _ptr(custom_need), _ptr(key_present),
        _ptr(available), _ptr(offering_owner), _ptr(has_offering),
        P, R, O, K, I, stream_handle(dev),
    )
    _raise_on(rc, "cube")
    LAUNCHES["cube"] += bool(P and I)
    return compat, has_offering


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
