"""The fused FFD scan (the one-dispatch solve) on the card.

`solve_scan` is the monotone FFD scan itself — the host walk's queue,
emptiest-first claim heap, existing-node scan pointers, claim opening and
nodepool-limit tracking — run as ONE kernel launch over the count tensors,
requirement-family transition tables and per-claim headroom matrices that
ops/fused.py builds. It replaces the reference's `lax.while_loop` program
(karpenter_tpu/ops/packer.py `_scan_program`, `_scan_init`, `_scan_finals`,
dispatched through `solve_scan_fn`); the group solver, the delta variants
and the mesh twins of that module are not ported here.

Decision parity is bit-for-bit: every float comparison runs in float64,
subtractions happen per join in the host's exact order, and claim
selection reproduces the host heap's (count, rank, claim-index) order as an
argmin over a packed int64 key.

`solve_scan(cfg, args)` is a wrapper: given CUDA tensors it allocates the
loop state and launches the hand-written kernel (csrc/scan.cu), given CPU
tensors it runs `solve_scan_plain`, a Python loop over float64/int64
tensors written from the reference program. Both return the reference's
10 outputs followed by `steps`, the number of loop iterations the scan ran.
`LAUNCHES` counts kernel launches only.
"""

from __future__ import annotations

import ctypes

import torch

from karpenter_tpu_torch.convert import SCAN_OPERANDS
from karpenter_tpu_torch.device import KernelError, kernel_library, stream_handle
from karpenter_tpu_torch.ops.feasibility import uid_project_plain

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

LAUNCHES: dict[str, int] = {"solve_scan": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scan_key(count: int, rank: int, ci: int) -> int:
    return count * (1 << 39) + (rank + (1 << 20)) * (1 << 18) + ci


# -- plain torch version -------------------------------------------------------


def solve_scan_plain(cfg: tuple, args: tuple) -> tuple:
    """The scan as a Python loop over float64/int64 tensors, one queue pop
    per iteration, mirroring the reference's (cond, body, init, finals).
    Scalars of the loop state are Python ints; every write the reference
    makes on a step, including the no-op ones, lands on the same cells.
    Returns the reference's 10 outputs, then the iteration count."""
    T, has_nodes, has_limits = cfg
    (
        pod_gi, claim_pad, g_req, g_floor, uniq_alloc, usage0, tol, open_ok,
        open_fam, open_uok, trans_kind, trans_fam, famu_ok, n_pods, n_nodes,
        node_ok, node_rem0, fam_mask, tmpl_mask, open_cand, uid_onehot,
        uid_of_type, cap_f, pool_of_t, pool_rem0, pool_has, pool_bad,
    ) = args
    dev = pod_gi.device
    i32, f64 = torch.int32, torch.float64
    P = pod_gi.shape[0]
    G, D = g_req.shape
    U = uniq_alloc.shape[0]
    C = claim_pad.shape[0]
    Qcap = 4 * P + 64
    I = tmpl_mask.shape[1] if has_limits else 1
    n_pods, n_nodes = int(n_pods), int(n_nodes)

    # -- _scan_init --
    head, tail, stop, abort, seqc, done, nclaims = 0, n_pods, False, SCAN_OK, 0, 0, 0
    steps = 0
    queue = torch.zeros(Qcap, dtype=i32, device=dev)
    queue[:P] = torch.arange(P, dtype=i32, device=dev)
    last_len = torch.full((P,), -1, dtype=i32, device=dev)
    pod_claim = torch.full((P,), -1, dtype=i32, device=dev)
    pod_node = torch.full((P,), -1, dtype=i32, device=dev)
    pod_seq = torch.full((P,), -1, dtype=i32, device=dev)
    claim_ti = torch.zeros(C, dtype=i32, device=dev)
    claim_fam = torch.zeros(C, dtype=i32, device=dev)
    claim_count = torch.zeros(C, dtype=i32, device=dev)
    claim_key = torch.full((C,), _SCAN_KEY_MAX, dtype=torch.int64, device=dev)
    u_valid = torch.zeros((C, U), dtype=torch.bool, device=dev)
    rem = torch.zeros((C, U, D), dtype=f64, device=dev)
    cfit = torch.zeros((C, G), dtype=torch.bool, device=dev)
    nptr = torch.zeros(G, dtype=i32, device=dev)
    node_rem = node_rem0.clone() if has_nodes else torch.zeros((1, D), dtype=f64, device=dev)
    tm_st = torch.zeros((C, I), dtype=torch.bool, device=dev)
    pool_rem = pool_rem0.clone() if has_limits else torch.zeros((1, D), dtype=f64, device=dev)
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
                pool_rem = pool_rem - sel_sub
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

    scalar = lambda v: torch.tensor(v, dtype=i32, device=dev)  # noqa: E731
    return (
        scalar(abort), scalar(nclaims), pod_claim, pod_node, pod_seq,
        claim_ti, claim_fam, u_valid, tm_st, pool_rem, scalar(steps),
    )


# -- kernel wrapper ------------------------------------------------------------

_lib_cache: list = []

# the kernel's parameter block (csrc/scan.cu ScanParams)
_N_PTRS = 24 + 17 + 1  # operands (less claim_pad, n_pods, n_nodes), state, scratch
_N_DIMS = 16


def _lib() -> ctypes.CDLL:
    if not _lib_cache:
        lib = kernel_library("scan")
        lib.kt_solve_scan.restype = ctypes.c_int
        lib.kt_solve_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _lib_cache.append(lib)
    return _lib_cache[0]


def solve_scan(cfg: tuple, args: tuple) -> tuple:
    """Run the fused scan. cfg = (T, has_nodes, has_limits), the static
    variant; args = the 27 operands (convert.scan_operands_from_numpy).
    Returns (abort, nclaims, pod_claim, pod_node, pod_seq, claim_ti,
    claim_fam, u_valid, tm_st, pool_rem, steps)."""
    if len(args) != SCAN_N_ARGS:
        raise ValueError(f"solve_scan takes {SCAN_N_ARGS} operands, got {len(args)}")
    first = args[0]
    if first.device.type == "cpu":
        return solve_scan_plain(cfg, args)
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    T, has_nodes, has_limits = cfg
    dev = first.device
    (
        pod_gi, claim_pad, g_req, g_floor, uniq_alloc, usage0, tol, open_ok,
        open_fam, open_uok, trans_kind, trans_fam, famu_ok, n_pods, n_nodes,
        node_ok, node_rem0, fam_mask, tmpl_mask, open_cand, uid_onehot,
        uid_of_type, cap_f, pool_of_t, pool_rem0, pool_has, pool_bad,
    ) = args
    for k, (t, (_, dt)) in enumerate(zip(args, SCAN_OPERANDS)):
        if t.device != dev:
            raise KernelError(f"solve_scan: operand {k} on {t.device}, expected {dev}")
        if t.dtype != dt:
            raise KernelError(f"solve_scan: operand {k} dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise KernelError(f"solve_scan: operand {k} not contiguous")
    P = pod_gi.shape[0]
    G, D = g_req.shape
    U = uniq_alloc.shape[0]
    C = claim_pad.shape[0]
    F = trans_kind.shape[0]
    I = fam_mask.shape[1]
    N = node_ok.shape[0] if has_nodes else 1
    L = pool_rem0.shape[0] if has_limits else 1
    Il = I if has_limits else 1
    WU = (U + 31) // 32
    Qcap = 4 * P + 64
    if not 0 < T <= 8:
        raise KernelError(f"solve_scan: {T} templates, the kernel takes 1..8")
    expect = {
        2: (G, D), 3: (G, D), 5: (T, D), 6: (T, G), 7: (T, G), 8: (T, G), 9: (T, G, U),
        10: (F, G), 11: (F, G), 12: (T, F, U), 13: (), 14: (), 20: (U, I), 23: (T,),
    }
    if has_nodes:
        expect.update({15: (N, G), 16: (N, D)})
    if has_limits:
        expect.update({18: (T, I), 19: (T, G, I), 21: (I,), 22: (I, D), 24: (L, D),
                       25: (L, D), 26: (L,)})
    for k, shape in expect.items():
        if tuple(args[k].shape) != shape:
            raise KernelError(f"solve_scan: operand {k} shape {tuple(args[k].shape)}, expected {shape}")
    if C >= 1 << 18 or Qcap >= 1 << 20:
        raise KernelError(f"solve_scan: C={C} or queue {Qcap} exceeds the int64 key packing")
    n_pods_v, n_nodes_v = int(n_pods), int(n_nodes)
    if not 0 <= n_pods_v <= P or (has_nodes and not 0 <= n_nodes_v <= N):
        raise KernelError(f"solve_scan: n_pods={n_pods_v} / n_nodes={n_nodes_v} outside the operands")

    def empty(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    # the 23-component loop state (the reference's _scan_init layout; the
    # seven scalars head, tail, stop, abort, seqc, done, nclaims in one
    # int32 vector, followed by the kernel's iteration count), initialized
    # by the kernel
    scal = empty(8)
    queue = empty(Qcap)
    last_len, pod_claim, pod_node, pod_seq = empty(P), empty(P), empty(P), empty(P)
    claim_ti, claim_fam, claim_count = empty(C), empty(C), empty(C)
    claim_key = empty(C, dtype=torch.int64)
    u_valid = empty(C, U, dtype=torch.bool)
    rem = empty(C, U, D, dtype=torch.float64)
    cfit = empty(C, G, dtype=torch.bool)
    nptr = empty(G)
    node_rem = empty(N, D, dtype=torch.float64)
    tm_st = empty(C, Il, dtype=torch.bool)
    pool_rem = empty(L, D, dtype=torch.float64)
    colw = empty(I * WU if has_limits else 1)  # packed uid_onehot columns

    ptrs = [
        pod_gi, g_req, g_floor, uniq_alloc, usage0, tol, open_ok, open_fam,
        open_uok, trans_kind, trans_fam, famu_ok, node_ok, node_rem0, fam_mask,
        tmpl_mask, open_cand, uid_onehot, uid_of_type, cap_f, pool_of_t,
        pool_rem0, pool_has, pool_bad,
        scal, queue, last_len, pod_claim, pod_node, pod_seq, claim_ti,
        claim_fam, claim_count, claim_key, u_valid, rem, cfit, nptr, node_rem,
        tm_st, pool_rem, colw,
    ]
    assert len(ptrs) == _N_PTRS
    dims = [P, G, C, U, D, F, T, N, I, L, Qcap, WU, n_pods_v, n_nodes_v,
            int(bool(has_nodes)), int(bool(has_limits))]
    assert len(dims) == _N_DIMS
    ptr_arr = (ctypes.c_void_p * _N_PTRS)(*(t.data_ptr() for t in ptrs))
    dim_arr = (ctypes.c_int * _N_DIMS)(*dims)
    rc = _lib().kt_solve_scan(ptr_arr, dim_arr, stream_handle(dev))
    if rc != 0:
        raise KernelError(f"solve_scan: CUDA launch failed with cudaError {rc}")
    LAUNCHES["solve_scan"] += 1
    return (
        scal[3], scal[6], pod_claim, pod_node, pod_seq,
        claim_ti, claim_fam, u_valid, tm_st, pool_rem, scal[7],
    )
