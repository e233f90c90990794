"""The port's one-launch group solve (kt_group_solve's three modes) against the JAX package.

On CPU tensors the wrappers run their plain torch versions, so these tests
hold the plain side of the kernel, which chip_smoke.py and
tests/test_torch_kernels.py hold the kernel against on the card, to the
reference: `solve_block_scatter` (the delta frontier: B10 and B11 in one
launch) against the JAX composition `delta_scatter_rows(core, slots,
solve_block_core_jit(...))`, with edge-padded duplicate, negative and
out-of-range slots; `delta_scatter_rows` alone on such slots;
`solve_block` and `solve_block_core` at the wide shapes the card tests use
(R or K past 2048, K=0, I past a chunk of types, offerings past a window); and
the one staged upload of the group rows (mesh.upload_rows' layout). Every comparison is exact: the
outputs are bools and int32.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu_torch import mesh as tmesh  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from torch_inputs import (  # noqa: E402
    GROUP_KERNEL_SHAPES, frontier_inputs, group_inputs, group_kernel_inputs, onehot, to_torch,
)

torch.set_num_threads(1)


def _jax_group_args(args):
    """The reference takes the [O, I] owner one-hot where the port takes
    owner indices."""
    return tuple(jnp.asarray(a) for a in args[:6] + (onehot(args[6], args[2].shape[1]),) + args[7:])


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, (g.dtype, want.dtype, g.shape, want.shape)
    np.testing.assert_array_equal(g, want)


@pytest.mark.parametrize("seed", range(12))
def test_solve_block_scatter_plain_matches_jax(seed):
    """The frontier pass: the port's one call against the reference's two
    programs, on edge-padded groups whose slots hold duplicates, a
    negative slot and two out of range; `core` written in place."""
    args = group_inputs(seed) if seed < 8 else group_kernel_inputs(seed)
    core, slots, fargs = frontier_inputs(args, seed)
    rows = jpacker.solve_block_core_jit(*_jax_group_args(fargs))
    want = jpacker.delta_scatter_rows(jnp.asarray(core), jnp.asarray(slots), rows)
    n0 = dict(tpacker.LAUNCHES)
    t_core = to_torch(core.copy())
    got = tpacker.solve_block_scatter(t_core, to_torch(slots), *(to_torch(a) for a in fargs))
    assert got is t_core  # in place
    assert tpacker.LAUNCHES == n0  # the plain version launches nothing
    _same(got, want)
    # the slots held the cases under test: one negative, two out of range
    G = slots.shape[0]
    if G - G // 4 >= 4:
        assert slots[0] < 0 and (slots[1] >= core.shape[0] or slots[2] < -core.shape[0])


@pytest.mark.parametrize("seed", range(6))
def test_delta_scatter_rows_drops_and_wraps_like_jax(seed):
    """B11 alone on the frontier's slots (negative: from the end; past
    either end: dropped; duplicates: equal rows)."""
    core, slots, fargs = frontier_inputs(group_inputs(seed), seed)
    rows = np.array(jpacker.solve_block_core_jit(*_jax_group_args(fargs)))
    want = jpacker.delta_scatter_rows(jnp.asarray(core), jnp.asarray(slots), jnp.asarray(rows))
    got = tpacker.delta_scatter_rows(to_torch(core.copy()), to_torch(slots), to_torch(rows))
    _same(got, want)


@pytest.mark.parametrize("seed", range(len(GROUP_KERNEL_SHAPES)))
def test_solve_block_wide_shapes_match_jax(seed):
    """B9 and B10 at the card tests' shapes: R past 2048, K past 2048, K=0,
    I past a block and past four, one group of one type, offerings past a
    window."""
    args = group_kernel_inputs(seed)
    jargs = _jax_group_args(args)
    targs = tuple(to_torch(a) for a in args)
    _same(tpacker.solve_block(*targs), jpacker.solve_block_jit(*jargs))
    _same(tpacker.solve_block_core(*targs), jpacker.solve_block_core_jit(*jargs))


@pytest.mark.parametrize("seed", range(4))
def test_group_rows_staging_layout(seed):
    """The one staged upload of a solve's rows (mesh.upload_rows): every
    array's rows at a 16-byte aligned offset of one buffer, and each
    array's view of the buffer equal to the array; on a CPU device the
    arrays themselves, uncopied."""
    args = group_inputs(seed)
    core, slots, fargs = frontier_inputs(args, seed)
    arrays = (fargs[0], fargs[1], slots)
    tensors = [torch.from_numpy(a) for a in arrays]
    G = slots.shape[0]
    offsets, total = tmesh.staging_layout(tensors, G)
    assert all(off % 16 == 0 for off in offsets) and total % 16 == 0
    sizes = [a.nbytes for a in arrays]
    assert all(offsets[k] + sizes[k] <= (offsets[k + 1] if k + 1 < len(offsets) else total)
               for k in range(len(arrays)))
    assert total < sum(sizes) + 16 * len(arrays)
    buf = np.zeros(total, dtype=np.uint8)
    tmesh.fill_staging(buf, tensors, [(0, G, 0)], offsets)
    views = tmesh.staged_views(torch.from_numpy(buf), tensors, offsets)
    for v, a in zip(views, arrays):
        assert v.dtype == torch.from_numpy(a).dtype and tuple(v.shape) == a.shape and v.is_contiguous()
        np.testing.assert_array_equal(v.numpy(), a)
    on_cpu = tmesh.upload_rows(arrays, torch.device("cpu"))
    assert all(np.shares_memory(t.numpy(), a) for t, a in zip(on_cpu, arrays))
    with pytest.raises(ValueError):
        tmesh.upload_rows((fargs[0], slots[:-1]), torch.device("cuda", 0))


@pytest.mark.parametrize("seed", range(len(GROUP_KERNEL_SHAPES) + 4))
def test_packed_catalog_holds_the_planes(seed):
    """pack_catalog's words unpack to the bool planes they pack (rows past
    R and keys past K are 0), and each type's offering range holds exactly
    the offerings it owns (offerings owner-major; a type without one has
    an empty range)."""
    args = group_kernel_inputs(seed) if seed < len(GROUP_KERNEL_SHAPES) else group_inputs(seed)
    rc, oc, cn, _, ow = args[2:7]
    packed = tpacker.pack_catalog(to_torch(rc), to_torch(oc), to_torch(cn), to_torch(ow))
    R, I = rc.shape
    O, K = cn.shape
    for words, plane in ((packed.req_words, rc), (packed.offer_words, oc), (packed.need_words, cn.T)):
        n = plane.shape[0]
        assert words.dtype == torch.int32 and tuple(words.shape) == ((n + 31) // 32, plane.shape[1])
        bits = (words.numpy().astype(np.uint32)[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
        bits = bits.reshape(-1, plane.shape[1]).astype(bool)
        np.testing.assert_array_equal(bits[:n], plane)
        assert not bits[n:].any()
    start = packed.type_start.numpy()
    assert packed.type_start.dtype == torch.int32 and start.shape == (I + 1,)
    assert start[0] == 0 and start[-1] == O and (np.diff(start) >= 0).all()
    for t in range(I):
        np.testing.assert_array_equal(np.flatnonzero(ow == t), np.arange(start[t], start[t + 1]))


@pytest.mark.parametrize("seed", range(4))
def test_packed_catalog_follows_the_catalog(seed):
    """The wrappers' packed catalog is reused only while its four source
    tensors are the same objects, unchanged: an in-place change repacks,
    and so does a grown catalog whose word counts match the old one (R from
    15 to 20 rows, one word either way); each pack equals pack_catalog of
    the tensors as they stand."""
    rng = np.random.RandomState(seed)
    args = group_inputs(seed)
    rc, oc, cn, ow = (to_torch(np.ascontiguousarray(a)) for a in (args[2], args[3], args[4], args[6]))

    def same(p, q):
        return all(torch.equal(x, y) for x, y in zip(p, q))

    first = tpacker._packed(rc, oc, cn, ow)
    assert same(first, tpacker.pack_catalog(rc, oc, cn, ow))
    assert tpacker._packed(rc, oc, cn, ow) is first
    r = int(rng.randint(rc.shape[0]))
    rc[r] = ~rc[r]
    oc[r] = ~oc[r]
    changed = tpacker._packed(rc, oc, cn, ow)
    assert changed is not first and same(changed, tpacker.pack_catalog(rc, oc, cn, ow))
    assert not torch.equal(changed.req_words, first.req_words)
    R = rc.shape[0]
    grow = 20 - R if R < 20 else 1
    rc2 = torch.cat([rc, torch.from_numpy(rng.rand(grow, rc.shape[1]) < 0.5)])
    oc2 = torch.cat([oc, torch.from_numpy(rng.rand(grow, oc.shape[1]) < 0.5)])
    grown = tpacker._packed(rc2, oc2, cn, ow)
    assert grown is not changed and same(grown, tpacker.pack_catalog(rc2, oc2, cn, ow))
    assert tpacker._packed(rc, oc, cn, ow) is changed
