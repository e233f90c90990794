"""B12 folded into the delta frontier's launch: a delta pass against the JAX package.

A delta group pass with a frontier is one call in the port,
`packer.delta_pass(core, slots, group_bools, group_ints, order, counts,
*catalog)`: on the card one kt_group_solve launch in its pass mode, whose
last block gathers and finalizes the pass. The reference runs three
programs: `delta_scatter_rows(core, slots, solve_block_core_jit(...))`,
then `delta_finalize(core, order, counts)` (karpenter_tpu/ops/delta.py). On
CPU tensors the wrapper runs its plain version, which chip_smoke.py and
tests/test_torch_kernels.py hold the kernel against on the card; here it is
held to the reference's composition, and a whole delta churn through
`GroupResidency.solve` to the reference's pass by pass, its count-only
passes (delta_finalize alone) included. Every comparison is exact: the
outputs are int32 and bools.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import delta as jdelta  # noqa: E402
from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu_torch.ops import delta as tdelta  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from test_torch_group import _m, build_shapes, churn_batch, engine_for  # noqa: E402
from torch_inputs import PASS_CASES, onehot, pass_inputs, to_torch  # noqa: E402

torch.set_num_threads(1)


def _jax_catalog(cat):
    """The reference takes the [O, I] owner one-hot where the port takes
    owner indices."""
    return tuple(jnp.asarray(a) for a in cat[:4] + (onehot(cat[4], cat[0].shape[1]),) + cat[5:])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("case", PASS_CASES)
def test_delta_pass_plain_matches_jax(case, seed):
    core, slots, gb, gi, order, counts, *cat = pass_inputs(case, seed)
    rows = jpacker.solve_block_core_jit(jnp.asarray(gb), jnp.asarray(gi), *_jax_catalog(tuple(cat)))
    want_core = jpacker.delta_scatter_rows(jnp.asarray(core), jnp.asarray(slots), rows)
    want = np.asarray(jpacker.delta_finalize(want_core, jnp.asarray(order), jnp.asarray(counts)))
    t_core = to_torch(core.copy())
    n0 = dict(tpacker.LAUNCHES)
    got = tpacker.delta_pass(t_core, *(to_torch(a) for a in (slots, gb, gi, order, counts)),
                             *(to_torch(a) for a in cat))
    assert tpacker.LAUNCHES == n0  # the plain version launches nothing
    assert got.dtype == torch.int32 and tuple(got.shape) == (order.shape[0], 4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(t_core.numpy(), np.asarray(want_core))  # core written in place


@pytest.mark.parametrize("seed", range(3))
def test_pass_upload_layout(seed):
    """A pass's int32 arrays and bool rows in one buffer, read back as
    views of their own shapes."""
    rng = np.random.RandomState(seed)
    G = int(rng.randint(1, 40))
    ints = (rng.randint(-9, 9, size=G).astype(np.int32),
            rng.randint(0, 99, size=(G, 5)).astype(np.int32),
            rng.randint(0, 50, size=8 * (seed + 1)).astype(np.int32))
    bools = rng.rand(G, 3 + seed) < 0.5
    out = tdelta._upload_pass(ints, bools, torch.device("cpu"))
    assert len(out) == 4
    for t, a in zip(out, ints + (bools,)):
        assert t.dtype == (torch.bool if a.dtype == bool else torch.int32) and t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), a)
    assert len(tdelta._upload_pass(ints[:1], None, torch.device("cpu"))) == 1


@pytest.fixture
def delta_both():
    """Delta solves on in both packages (a self-check every 3 warm passes),
    every residency dropped before and after."""
    saved = [(mod, mod.DELTA_MODE, mod.RESOLVE_FULL_EVERY) for mod in (jdelta, tdelta)]
    for mod in (jdelta, tdelta):
        mod.configure(mode="on", resolve_full_every=3)
        mod.invalidate_all("test-setup")
    yield
    for mod, mode, every in saved:
        mod.configure(mode=mode, resolve_full_every=every)
        mod.invalidate_all("test-teardown")


def test_delta_churn_matches_jax_pass_by_pass(delta_both, monkeypatch):
    """One churn through both packages' GroupResidency.solve: a cold pass, a
    count-only pass (pods added to existing shapes), a pass with new
    shapes, a count-only pass with fewer groups, then mixed batches. Every
    pass's outputs, cold/warm mode and solved/reused counts equal the
    reference's; in the port a pass with a frontier is one delta_pass call
    and no delta_finalize, a count-only pass one delta_finalize."""
    calls = []

    def counted(name):
        real = getattr(tpacker, name)

        def shim(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        return shim

    for name in ("delta_pass", "delta_finalize", "solve_block_scatter"):
        monkeypatch.setattr(tpacker, name, counted(name))
    seen = {}
    for pkg, dmod in (("karpenter_tpu", jdelta), ("karpenter_tpu_torch", tdelta)):
        wk = _m(pkg, "apis.labels")
        engine = engine_for(pkg)
        packer = _m(pkg, "ops.packer")
        solver = packer.GroupSolver(engine)
        res = dmod.group_residency(solver)
        rng = np.random.RandomState(33)
        reqs, requests = churn_batch(pkg, engine, rng, build_shapes(pkg, 8), 90)
        extra = np.tile(requests[:1], (4, 1))
        extra[:, engine.resource_dims[wk.RESOURCE_CPU]] = 3.0  # a request no shape has
        batches = [
            (reqs, requests),
            (reqs + reqs[:30], np.vstack([requests, requests[:30]])),
            (reqs + reqs[:4], np.vstack([requests, extra])),
            (reqs[:40], requests[:40]),
        ]
        for p in range(3):
            batches.append(churn_batch(pkg, engine, rng, build_shapes(pkg, 8 + p), 60 + 25 * p))
        trace = []
        for r, q in batches:
            c0 = dmod.delta_counters()
            n0 = len(calls)
            got = solver.solve(packer.encode_pods_for_packer(engine, r, q))
            c1 = dmod.delta_counters()
            solved = c1["delta_groups_solved"] - c0["delta_groups_solved"]
            trace.append((res.last_mode, solved, c1["delta_groups_reused"] - c0["delta_groups_reused"],
                          tuple(np.asarray(a).tobytes() for a in got)))
            if pkg == "karpenter_tpu_torch":
                assert calls[n0:] == (["delta_pass"] if solved else ["delta_finalize"]), calls[n0:]
        seen[pkg] = trace
        del solver, engine
    assert seen["karpenter_tpu_torch"] == seen["karpenter_tpu"]
    modes = [(t[0], t[1]) for t in seen["karpenter_tpu_torch"]]
    assert modes[0][0] == "cold" and modes[1] == ("warm", 0) and modes[2][1] > 0 and modes[3] == ("warm", 0)
