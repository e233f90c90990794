"""Seeded numpy inputs for the port's feasibility functions, shared by the
torch tests. numpy only, so the card-side tests need no jax."""

from __future__ import annotations

import numpy as np
import torch

# the reference encoding's sentinels (karpenter_tpu/ops/encoding.py); the
# port's copies are asserted equal in test_torch_feasibility.py
NO_GT = -(2**31)
NO_LT = 2**31 - 1
NOT_INT = -(2**31)


def row_inputs(seed: int):
    """Random rows and sets at the row kernel's layout: padding slots carry
    slot_key -1 and value_int NOT_INT; some rows/sets carry Gt/Lt bounds,
    some are complements."""
    rng = np.random.RandomState(seed)
    R = (1, 5, 33, 12)[seed % 4]
    N = (1, 17, 70, 40)[(seed // 2) % 4]
    K = (8, 16)[seed % 2]
    W = (2, 4)[(seed // 3) % 2]
    G = 32 * W
    used = int(rng.randint(1, G))
    slot_key = np.full(G, -1, np.int32)
    slot_key[:used] = rng.randint(0, K, size=used)
    value_int = np.full(G, NOT_INT, np.int32)
    ints = rng.rand(used) < 0.5
    value_int[:used][ints] = rng.randint(-20, 20, size=int(ints.sum()))

    def bounds(shape):
        gt = np.full(shape, NO_GT, np.int32)
        lt = np.full(shape, NO_LT, np.int32)
        m = rng.rand(*shape) < 0.3
        gt[m] = rng.randint(-25, 15, size=int(m.sum()))
        m = rng.rand(*shape) < 0.3
        lt[m] = rng.randint(-15, 25, size=int(m.sum()))
        return gt, lt

    def words(shape):
        a = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        b = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        return a & b

    r_gt, r_lt = bounds((R,))
    s_gt, s_lt = bounds((N, K))
    return (
        rng.randint(0, K, size=R).astype(np.int32),
        rng.rand(R) < 0.4,
        rng.rand(R) < 0.7,
        r_gt,
        r_lt,
        words((R, W)),
        rng.rand(N, K) < 0.6,
        rng.rand(N, K) < 0.4,
        rng.rand(N, K) < 0.7,
        s_gt,
        s_lt,
        words((N, W)),
        slot_key,
        value_int,
    )


def cube_inputs(seed: int):
    """Random sweep inputs with owner-major offerings."""
    rng = np.random.RandomState(100 + seed)
    P = (1, 8, 16, 32)[seed % 4]
    R = (1, 4, 8, 32)[(seed // 2) % 4]
    I = (1, 7, 33)[seed % 3]
    O = (1, 20, 70)[(seed // 3) % 3]
    K = 8
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    return (
        rng.rand(P, R) < 0.3,
        rng.rand(R, I) < 0.8,
        rng.rand(R, O) < 0.8,
        rng.rand(O, K) < 0.2,
        rng.rand(P, K) < 0.5,
        rng.rand(O) < 0.8,
        owner,
    )


def target_inputs(seed: int, targets: int = 2):
    """A row batch against one or two targets, at req_rows_vs_targets'
    layout: (the six row arrays, one six-array set tuple per target,
    slot_key, value_int). The first target's sets come from row_inputs;
    the second's are drawn at the same keys and words (bounded and
    complement sets among them)."""
    args = row_inputs(seed)
    rows, first, slot_key, value_int = args[:6], args[6:12], args[12], args[13]
    sets = [first]
    if targets == 2:
        rng = np.random.RandomState(500 + seed)
        N, K = rng.randint(1, 90), first[0].shape[1]
        W = first[5].shape[1]
        gt = np.where(rng.rand(N, K) < 0.3, rng.randint(-25, 15, size=(N, K)), NO_GT).astype(np.int32)
        lt = np.where(rng.rand(N, K) < 0.3, rng.randint(-15, 25, size=(N, K)), NO_LT).astype(np.int32)
        mask = (rng.randint(0, 2**32, size=(N, W), dtype=np.uint64)
                & rng.randint(0, 2**32, size=(N, W), dtype=np.uint64)).astype(np.uint32)
        sets.append((rng.rand(N, K) < 0.6, rng.rand(N, K) < 0.4, rng.rand(N, K) < 0.7, gt, lt, mask))
    return rows, sets, slot_key, value_int


SWEEP_ROW_CASES = ("sorted", "repeated", "empty")


def sweep_inputs(seed: int, rows_case: str = "sorted"):
    """cube_rows' inputs from cube_inputs' catalog: a resident matrix of
    Rtot rows, R of them picked by index (sorted and unique, with repeats,
    or none), membership padded to a power of two of columns (the padding
    all False). Returns (membership, key_present, rows, req_compat,
    offer_compat, custom_need, available, owner)."""
    membership, req_compat, offer_compat, custom_need, key_present, available, owner = cube_inputs(seed)
    rng = np.random.RandomState(600 + seed)
    P, R = membership.shape
    extra = int(rng.randint(1, 6))
    Rtot = R + extra
    perm = rng.permutation(Rtot)
    req_all = np.concatenate([req_compat, rng.rand(extra, req_compat.shape[1]) < 0.5])[perm]
    offer_all = np.concatenate([offer_compat, rng.rand(extra, offer_compat.shape[1]) < 0.5])[perm]
    where = np.argsort(perm)[:R]  # row r of cube_inputs lies at where[r]
    if rows_case == "sorted":
        order = np.argsort(where)
        rows, membership = where[order], membership[:, order]
    elif rows_case == "repeated":
        rows = np.concatenate([where, where[:1]])
        membership = np.concatenate([membership, membership[:, :1]], axis=1)
    else:
        rows, membership = where[:0], membership[:, :0]
    width = 1 << max(0, (max(rows.shape[0], 1) - 1).bit_length())
    padded = np.zeros((P, width), dtype=bool)
    padded[:, : rows.shape[0]] = membership
    return (padded, key_present, rows.astype(np.int32), req_all, offer_all, custom_need, available,
            owner)


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def onehot(owner: np.ndarray, num_instances: int) -> np.ndarray:
    out = np.zeros((owner.shape[0], num_instances), dtype=bool)
    out[np.arange(owner.shape[0]), owner] = True
    return out


def uid_inputs(seed: int, lead: tuple):
    """A [U, I] one-hot of a random uid_of_type (every uid owns a type) and
    a random [*lead, I] type mask."""
    rng = np.random.RandomState(200 + seed)
    U = (1, 3, 36, 40)[seed % 4]
    I = U + int(rng.randint(0, 70))
    uid_of_type = np.concatenate([np.arange(U), rng.randint(0, U, size=I - U)])
    rng.shuffle(uid_of_type)
    onehot = np.zeros((U, I), dtype=bool)
    onehot[uid_of_type, np.arange(I)] = True
    return onehot, rng.rand(*lead, I) < (0.02, 0.1, 0.5)[seed % 3]


def scan_inputs(seed: int, has_nodes: bool, has_limits: bool):
    """The fused scan's 27 operands in the reference's layout and dtypes
    (karpenter_tpu/ops/fused.py builds them from a solve), drawn at random
    but consistent: every index in range, padding as the builder pads
    (groups past G carry g_floor -1e-9 and REJECT transitions, pods past
    n_pods carry group -1), famu_ok the uid projection of tmpl_mask and
    fam_mask. Resources are multiples of 0.5, so exact ties hit the 1e-9
    fit edges; even seeds carry a group that fits nothing, seed 2 mod 3 a
    claim axis too short for the batch, seed 3 a claim axis of 16384 slots,
    past the shared-memory budget of the kernel's resident design. Returns
    ((T, has_nodes, has_limits), operands)."""
    rng = np.random.RandomState(300 + seed)
    T = int(rng.randint(1, 4))
    Pr, Pb = int(rng.randint(40, 200)), 256
    Gr, Gb = int(rng.randint(3, 12)), 16
    Fr, Fb = int(rng.randint(2, 7)), 8
    U, I, D = int(rng.randint(1, 7)), int(rng.randint(8, 40)), 3
    C = 16384 if seed == 3 else (256, 64, 16)[seed % 3]  # 16 slots overflow: SCAN_CLAIM_OVERFLOW
    half = lambda lo, hi, shape: rng.randint(lo, hi, size=shape) * 0.5  # noqa: E731

    pod_gi = np.full(Pb, -1, np.int32)
    pod_gi[:Pr] = rng.randint(0, Gr, size=Pr)
    g_req = np.zeros((Gb, D))
    g_req[:Gr] = half(0, 9, (Gr, D))
    g_floor = np.full((Gb, D), -1e-9)
    if seed % 2 == 0:
        g_req[0] = half(60, 80, D)  # fits nothing: requeues, then the cycle stop
    g_floor[:Gr] = g_req[:Gr] - 1e-9
    uid_of_type = np.concatenate([np.arange(U), rng.randint(0, U, size=I - U)]).astype(np.int32)
    rng.shuffle(uid_of_type)
    uniq_alloc = half(8, 40, (U, D))
    usage0 = half(0, 2, (T, D))
    tol = np.zeros((T, Gb), bool)
    tol[:, :Gr] = rng.rand(T, Gr) < 0.9
    open_ok = np.zeros((T, Gb), bool)
    open_ok[:, :Gr] = rng.rand(T, Gr) < 0.85
    if seed % 2 == 0:
        open_ok[:, 0] = False  # group 0 fits nothing (above): no template opens it
    open_fam = np.zeros((T, Gb), np.int32)
    open_fam[:, :Gr] = rng.randint(0, Fr, size=(T, Gr))
    open_uok = np.zeros((T, Gb, U), bool)
    open_uok[:, :Gr] = rng.rand(T, Gr, U) < 0.7
    trans_kind = np.zeros((Fb, Gb), np.int8)
    trans_kind[:Fr, :Gr] = rng.choice([0, 1, 1, 2, 2], size=(Fr, Gr))
    trans_fam = np.zeros((Fb, Gb), np.int32)
    same = trans_kind == 1
    trans_fam[same] = np.nonzero(same)[0]
    narrow = trans_kind == 2
    trans_fam[narrow] = rng.randint(0, Fr, size=int(narrow.sum()))
    fam_mask = np.zeros((Fb, I), bool)
    fam_mask[:Fr] = rng.rand(Fr, I) < 0.7
    tmpl_mask = rng.rand(T, I) < 0.8
    onehot = np.zeros((U, I), bool)
    onehot[uid_of_type, np.arange(I)] = True
    famu_ok = ((tmpl_mask[:, None, :] & fam_mask[None, :, :])[:, :, None, :] & onehot).any(-1)

    dummy2, dummyb = np.zeros((1, 1)), np.zeros((1, 1), bool)
    Nr = 0
    node_ok, node_rem0 = dummyb, dummy2
    if has_nodes:
        Nr, Nb = int(rng.randint(1, 12)), 16
        node_ok = np.zeros((Nb, Gb), bool)
        node_ok[:Nr, :Gr] = rng.rand(Nr, Gr) < 0.6
        node_rem0 = np.zeros((Nb, D))
        node_rem0[:Nr] = half(0, 30, (Nr, D))
    pool_of_t = np.full(T, -1, np.int32)
    open_cand, tmpl_maskP, cap_f = dummyb[None], dummyb, dummy2
    uid_of_typeP = np.zeros(1, np.int32)
    pool_rem0, pool_has, pool_bad = dummy2, dummyb, np.zeros(1, bool)
    if has_limits:
        L = int(rng.randint(1, 3))
        pool_of_t = rng.randint(-1, L, size=T).astype(np.int32)
        pool_of_t[0] = 0
        open_cand = np.zeros((T, Gb, I), bool)
        open_cand[:, :Gr] = rng.rand(T, Gr, I) < 0.7
        tmpl_maskP = tmpl_mask
        cap_f = uniq_alloc[uid_of_type] + half(0, 3, (I, D))
        uid_of_typeP = uid_of_type
        pool_rem0 = half(20, 400, (L, D))
        pool_has = rng.rand(L, D) < 0.7
        pool_bad = rng.rand(L) < 0.1
    args = (
        pod_gi, np.zeros(C, np.int32), g_req, g_floor, uniq_alloc, usage0,
        tol, open_ok, open_fam, open_uok, trans_kind, trans_fam, famu_ok,
        np.int32(Pr), np.int32(Nr), node_ok, node_rem0,
        fam_mask, tmpl_maskP, open_cand, onehot, uid_of_typeP, cap_f,
        pool_of_t, pool_rem0, pool_has, pool_bad,
    )
    return (T, has_nodes, has_limits), args


SCAN_EDGE_CASES = ("requeue_last", "cycle_stop", "claim_overflow", "keys_max", "queue_overflow")


def scan_edge_inputs(case: str):
    """Operands of the plain variant (scan_inputs(0): group 0 fits nothing
    and no template opens it) that drive the scan's loop to one edge:

    - requeue_last: every pod but the last is placed (every other group may
      open a claim), the last is group 0: it fails when head + 1 == tail,
      is requeued as the only pod left, and stops the loop the next step;
    - cycle_stop: every fourth pod is group 0: the failures requeue behind
      the placed pods and the second pass over them stops on the cycle
      check;
    - claim_overflow: scan_inputs(2), 16 claim slots for the batch;
    - keys_max: group 1 may join no claim (its transitions all REJECT), so
      each of its pods finds only KEY_MAX keys, with claims open, and opens
      its own;
    - queue_overflow: as requeue_last, but the last three pods are group 0;
      the caller solves the prefix of the other pods, moves head and tail to
      Qcap - 4 and resumes with the three: they fill the queue but for its
      last slot, the first failure is requeued there, and the second finds
      the queue full (the reference's resume enqueue is defined while
      tail + the suffix stays below Qcap).

    Returns ((T, False, False), operands, p_lo), p_lo the first suffix pod
    (queue_overflow) or None."""
    if case == "claim_overflow":
        cfg, args = scan_inputs(2, False, False)
        return cfg, args, None
    cfg, args = scan_inputs(0, False, False)
    args = list(args)
    n_pods = int(args[13])
    pod_gi, tol, open_ok, trans_kind = (args[k].copy() for k in (0, 6, 7, 10))
    real = pod_gi[:n_pods]
    real[real == 0] = 1
    groups = np.unique(real)
    tol[:, groups] = True
    open_ok[:, groups] = True
    p_lo = None
    if case == "requeue_last":
        real[-1] = 0
    elif case == "cycle_stop":
        real[::4] = 0
    elif case == "keys_max":
        trans_kind[:, 1] = 0
    elif case == "queue_overflow":
        real[-3:] = 0
        p_lo = n_pods - 3
    else:
        raise ValueError(case)
    args[0], args[6], args[7], args[10] = pod_gi, tol, open_ok, trans_kind
    return cfg, tuple(args), p_lo


def offering_inputs(seed: int):
    """Random offering_reduce inputs (owner-major offerings): ragged P/R/O,
    K=0 on every third seed, and offering 0 never available. Returns the
    six operands with owner indices, then the type count."""
    rng = np.random.RandomState(500 + seed)
    P = (1, 5, 16, 33)[seed % 4]
    R = (1, 3, 8, 40)[(seed // 2) % 4]
    K = (0, 4, 8)[seed % 3]
    I = (1, 9, 40)[(seed // 3) % 3]
    O = I + int(rng.randint(0, 2 * I + 1))
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    available = rng.rand(O) < 0.8
    available[0] = False
    return (
        rng.rand(P, R) < 0.3,
        rng.rand(R, O) < 0.85,
        rng.rand(O, K) < 0.15,
        rng.rand(P, K) < 0.5,
        available,
        owner,
    ), I


def group_inputs(seed: int):
    """Random group-solver operands in the reference's layout (group_bools
    [G, R+K], group_ints [G, D+1] int32, then the seven catalog operands
    with owner indices): price ties (prices from a small set), zero and
    negative requests, negative allocatable (floor division), an
    all-infeasible group on even seeds, types without an available offering
    (price inf, as GroupSolver builds it)."""
    rng = np.random.RandomState(600 + seed)
    G = (1, 5, 16, 33)[seed % 4]
    R = (1, 3, 8)[seed % 3]
    K = (0, 4, 8)[(seed // 2) % 3]
    I = (1, 9, 40)[(seed // 3) % 3]
    D = 4
    O = I + int(rng.randint(0, 2 * I + 1))
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    available = rng.rand(O) < 0.8
    offer_price = rng.choice([0.5, 1.0, 1.25, 2.0], size=O).astype(np.float32)
    price = np.full(I, np.inf, dtype=np.float32)
    for o in range(O):
        if available[o]:
            price[owner[o]] = min(price[owner[o]], offer_price[o])
    membership = rng.rand(G, R) < 0.3
    key_present = rng.rand(G, K) < 0.5
    requests_q = rng.randint(-1, 12, size=(G, D)).astype(np.int32)
    requests_q[rng.rand(G, D) < 0.3] = 0
    if seed % 2 == 0:
        requests_q[0] = 1000  # fits no type: all-infeasible
    alloc_q = rng.randint(-3, 40, size=(I, D)).astype(np.int32)
    counts = rng.randint(0, 50, size=G).astype(np.int32)
    return (
        np.concatenate([membership, key_present], axis=1),
        np.concatenate([requests_q, counts[:, None]], axis=1),
        rng.rand(R, I) < 0.85,
        rng.rand(R, O) < 0.85,
        rng.rand(O, K) < 0.15,
        available,
        owner,
        alloc_q,
        price,
    )


# ragged shapes of the fused sharded kernels (kt_cube_fused, kt_group_solve):
# (entities, R, K, I, O, D): R and K past 32 and not multiples of it, I not
# a multiple of a block (128 for the cube, 1024 for the group solve) and past
# 1024, entity counts that are not multiples of 32, K = 0
MESH_KERNEL_SHAPES = ((45, 37, 45, 1000, 4000, 4), (3, 8, 8, 1008, 8064, 4),
                      (200, 16, 0, 1500, 3001, 2), (70, 70, 9, 130, 900, 6))


def mesh_kernel_inputs(seed: int, n: int):
    """Operands of the sharded cube and group solve on an n-shard mesh, at
    MESH_KERNEL_SHAPES[seed % 4]: the entity axis padded as the engine pads
    it (pow2 aligned to lcm(n, 8); padding rows all-False and zero, so
    at 3 entities every shard past the first is padding only); owner-major
    offerings with type 3 owning none and type 5's never available; prices
    from a small set (ties); group 0 fitting no type. Returns (P, the cube's
    seven operands, the group solve's nine)."""
    rng = np.random.RandomState(900 + seed)
    P, R, K, I, O, D = MESH_KERNEL_SHAPES[seed % 4]
    align = (n * 8) // np.gcd(n, 8)
    P2 = -(-max(1 << max(0, (P - 1).bit_length()), align) // align) * align
    owner = np.sort(rng.choice(np.setdiff1d(np.arange(I), [3]), size=O)).astype(np.int32)
    available = rng.rand(O) < 0.9
    available[owner == 5] = False
    offer_price = rng.choice([0.25, 0.5, 1.0, 2.0], size=O).astype(np.float32)
    price = np.full(I, np.inf, dtype=np.float32)
    np.minimum.at(price, owner[available], offer_price[available])
    membership = np.zeros((P2, R), dtype=bool)
    membership[:P] = rng.rand(P, R) < min(1.0, 4.0 / R)
    key_present = np.zeros((P2, K), dtype=bool)
    key_present[:P] = rng.rand(P, K) < 0.5
    group_ints = np.zeros((P2, D + 1), dtype=np.int32)
    group_ints[:P, :D] = rng.randint(0, 16, size=(P, D)) * (rng.rand(P, D) > 0.3)
    group_ints[0, :D] = 1 << 20
    group_ints[:P, D] = rng.randint(1, 500, size=P)
    req_compat, offer_compat = rng.rand(R, I) < 0.9, rng.rand(R, O) < 0.9
    custom_need = rng.rand(O, K) < 0.05
    alloc_q = rng.randint(-2, 64, size=(I, D)).astype(np.int32)
    cube = (membership, req_compat, offer_compat, custom_need, key_present, available, owner)
    group = (np.concatenate([membership, key_present], axis=1), group_ints, req_compat,
             offer_compat, custom_need, available, owner, alloc_q, price)
    return P, cube, group


def core_inputs(seed: int):
    """A resident [cap, 3] core matrix (feasible entries other than 0/1
    too, pods-per-node down to -1), edge-padded scatter slots and rows, and
    a padded gather order with counts."""
    rng = np.random.RandomState(700 + seed)
    cap = (8, 64, 128)[seed % 3]
    core = np.stack([
        rng.randint(0, 50, size=cap), rng.randint(0, 3, size=cap), rng.randint(-1, 12, size=cap),
    ], axis=1).astype(np.int32)
    n = int(rng.randint(1, cap + 1))
    slots = rng.permutation(cap)[:n].astype(np.int32)
    pad = (8 - n % 8) % 8
    rows = np.stack([
        rng.randint(0, 50, size=n), rng.randint(0, 2, size=n), rng.randint(0, 12, size=n),
    ], axis=1).astype(np.int32)
    slots = np.pad(slots, (0, pad), mode="edge")
    rows = np.pad(rows, ((0, pad), (0, 0)), mode="edge")
    g = int(rng.randint(1, cap + 1))
    gb = max(8, 1 << (g - 1).bit_length())
    order = np.pad(rng.randint(0, cap, size=g).astype(np.int32), (0, gb - g), mode="edge")
    counts = np.pad(rng.randint(0, 100, size=g).astype(np.int32), (0, gb - g))
    return core, slots, rows, order, counts


def fits_inputs(seed: int, dtype):
    """Requests and allocatables in float32 or int32, with zero capacities
    (a positive request against one fails, a zero request passes) and
    requests equal to a capacity."""
    rng = np.random.RandomState(200 + seed)
    P, I, D = (1, 5, 17, 1100)[seed % 4], (1, 9, 33)[seed % 3], (1, 4, 11)[seed % 3]
    alloc = rng.randint(0, 8, size=(I, D)).astype(dtype)
    alloc[rng.rand(I, D) < 0.2] = 0
    req = rng.randint(0, 8, size=(P, D)).astype(dtype)
    req[rng.rand(P, D) < 0.3] = 0
    req[0, 0] = 1
    if dtype == np.float32:
        req += rng.choice([0.0, 0.25, -0.5], size=(P, D)).astype(np.float32)
    return req, alloc


def stage_inputs(seed: int):
    """Three bool planes of one shape for stage_plane."""
    rng = np.random.RandomState(400 + seed)
    shape = ((3, 17), (1, 1), (2, 5, 33), (64,))[seed % 4]
    return tuple(rng.rand(*shape) < p for p in (0.8, 0.7, 0.6))


# kt_group_solve's shapes in the card tests (G, R, K, I, O, D): R past 2048
# (past the 64 mask words the kernel once held), K past 2048, K = 0, I past
# a block of 1024 threads (two chunks of types), a single group and type,
# I past four chunks, one chunk's offerings past a window of 32,768
GROUP_KERNEL_SHAPES = ((33, 2100, 40, 300, 900, 4), (7, 3, 2100, 50, 200, 2),
                       (16, 5, 0, 1100, 3000, 4), (40, 37, 9, 1008, 8064, 4), (1, 1, 0, 1, 1, 4),
                       (4, 3, 2, 4500, 5000, 4), (3, 3, 2, 60, 40000, 4))


def group_kernel_inputs(seed: int):
    """Group-solver operands (group_inputs' layout) at
    GROUP_KERNEL_SHAPES[seed % 7]: about four rows a group, so wide R
    stays sparse; group 0 fitting no type (all-infeasible); prices from a
    small set (ties); types without an available offering."""
    rng = np.random.RandomState(1100 + seed)
    G, R, K, I, O, D = GROUP_KERNEL_SHAPES[seed % len(GROUP_KERNEL_SHAPES)]
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    available = rng.rand(O) < 0.85
    offer_price = rng.choice([0.25, 0.5, 1.0, 2.0], size=O).astype(np.float32)
    price = np.full(I, np.inf, dtype=np.float32)
    np.minimum.at(price, owner[available], offer_price[available])
    requests_q = rng.randint(0, 16, size=(G, D)).astype(np.int32)
    requests_q[rng.rand(G, D) < 0.3] = 0
    requests_q[0] = 1 << 20
    return (
        np.concatenate([rng.rand(G, R) < min(1.0, 4.0 / R), rng.rand(G, K) < 0.5], axis=1),
        np.concatenate([requests_q, rng.randint(0, 500, size=(G, 1)).astype(np.int32)], axis=1),
        rng.rand(R, I) < 0.95,
        rng.rand(R, O) < 0.95,
        rng.rand(O, K) < 0.05,
        available,
        owner,
        rng.randint(-2, 64, size=(I, D)).astype(np.int32),
        price,
    )


def frontier_inputs(args: tuple, seed: int):
    """The delta frontier as the residency hands it over, from group
    operands `args`: the groups' last quarter edge-padded (rows equal to
    the last real group's, slots repeating its slot), distinct slots for
    the real groups in a [cap, 3] core matrix with cap = 2 G + 8, one of
    them given negative (slot - cap, counting from the end), one past the
    end (cap + 3) and one before the start (-cap - 2), both dropped.
    Returns (core, slots, args with the padded group rows)."""
    rng = np.random.RandomState(1300 + seed)
    gb, gi = args[0].copy(), args[1].copy()
    G = gb.shape[0]
    cap = 2 * G + 8
    real = max(1, G - G // 4)
    gb[real:] = gb[real - 1]
    gi[real:] = gi[real - 1]
    slots = rng.permutation(cap)[:real].astype(np.int32)
    if real >= 4:
        slots[0] -= cap
        slots[1] = cap + 3
        slots[2] = -cap - 2
    slots = np.pad(slots, (0, G - real), mode="edge")
    core = np.stack([rng.randint(0, 50, size=cap), rng.randint(0, 3, size=cap),
                     rng.randint(-1, 12, size=cap)], axis=1).astype(np.int32)
    return core, slots, (gb, gi) + tuple(args[2:])


# the fused scan's famu_ok at factored shapes (uid_project_factored, B6):
# templates 1, 2 and 4; families 1, 7 (ragged) and 64 (the workload's);
# uids 1, past 32 and past 64; types 1, 31 (rows of no 16-byte multiple)
# and the workload's 1008
FAMU_T = (1, 2, 4)
FAMU_F = (1, 7, 64)
FAMU_U = (1, 33, 70)
FAMU_I = (1, 31, 1008)


def famu_inputs(T: int, F: int, U: int, I: int, seed: int = 0):
    """uid_of_type [I] (each uid owning a type while there are types for
    it), tmpl_mask [T, I] and fam_mask [F, I] bool: the last template row
    and the first family row all-false when there are two or more, sparse
    families so that many (t, f, u) survive nothing."""
    rng = np.random.RandomState(900 + 1000 * seed + 100 * T + 10 * F + U + I)
    uid_of_type = rng.randint(0, U, size=I)
    k = min(U, I)
    uid_of_type[rng.permutation(I)[:k]] = rng.permutation(U)[:k]
    tmpl = rng.rand(T, I) < 0.6
    fam = rng.rand(F, I) < 0.08
    if T > 1:
        tmpl[-1] = False
    if F > 1:
        fam[0] = False
    return uid_of_type.astype(np.int32), tmpl, fam


# a delta pass with a frontier (delta_pass, B10 + B11 + B12): one frontier
# row; fewer frontier rows than the pass's groups; edge-padded duplicate
# slots; a negative slot (counting from the end); slots past either end
# (dropped)
PASS_CASES = ("one_row", "fewer_than_groups", "edge_padded", "negative_slot", "out_of_range_slot")


def pass_inputs(case: str, seed: int):
    """(core, slots, group_bools, group_ints, order, counts, *catalog) as the
    group residency hands a pass with a frontier to delta_pass: a random
    [cap, 3] core matrix, the frontier's group rows (group_inputs) and their
    slots, and the pass's order over the core (the frontier's slots among
    older ones, edge-padded to the pow2 rung, floor 8) with its counts
    (zero on the padding)."""
    args = group_inputs(seed)
    rng = np.random.RandomState(1500 + 31 * seed + PASS_CASES.index(case))
    gb, gi = args[0].copy(), args[1].copy()
    if case == "one_row":
        gb, gi = gb[:1], gi[:1]
    G = gb.shape[0]
    cap = 2 * G + 16
    slots = rng.permutation(cap)[:G].astype(np.int32)
    if case == "edge_padded":
        Gb = max(8, 1 << (G - 1).bit_length())
        gb = np.pad(gb, ((0, Gb - G), (0, 0)), mode="edge")
        gi = np.pad(gi, ((0, Gb - G), (0, 0)), mode="edge")
        slots = np.pad(slots, (0, Gb - G), mode="edge")
    elif case == "negative_slot":
        slots[0] -= cap
    elif case == "out_of_range_slot":
        slots[0] = cap + 3
        if G > 1:
            slots[-1] = -cap - 2
    core = np.stack([rng.randint(0, 50, size=cap), rng.randint(0, 3, size=cap),
                     rng.randint(-1, 12, size=cap)], axis=1).astype(np.int32)
    written = [s % cap for s in slots if -cap <= s < cap]
    g = len(written) + int(rng.randint(1, 6))
    order = np.concatenate([written, rng.randint(0, cap, size=g - len(written))]).astype(np.int32)
    rng.shuffle(order)
    Gb = max(8, 1 << (g - 1).bit_length())
    order = np.pad(order, (0, Gb - g), mode="edge")
    counts = np.pad(rng.randint(0, 100, size=g).astype(np.int32), (0, Gb - g))
    return (core, slots, gb, gi, order, counts) + tuple(args[2:])
