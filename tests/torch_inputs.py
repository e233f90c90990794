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


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def onehot(owner: np.ndarray, num_instances: int) -> np.ndarray:
    out = np.zeros((owner.shape[0], num_instances), dtype=bool)
    out[np.arange(owner.shape[0]), owner] = True
    return out
