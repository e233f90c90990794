"""The port's group solver (ops/packer.py, ops/feasibility.py) against the JAX package's.

The same numpy-seeded operands go through the JAX programs — feasibility
`offering_reduce` (B8), packer `solve_block_jit` (B9),
`solve_block_core_jit` (B10), `delta_scatter_rows` (B11) and
`delta_finalize` (B12) — and through the port's wrappers on CPU tensors,
which run the plain torch versions. Then whole `GroupSolver` solves, full
and with the delta residency, against the JAX `GroupSolver` on the same
`encode_pods_for_packer` inputs. Every comparison is exact (tolerance 0):
the outputs are bools and int32.
"""

from __future__ import annotations

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import delta as jdelta  # noqa: E402
from karpenter_tpu.ops import feasibility as jfeas  # noqa: E402
from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu_torch import convert  # noqa: E402
from karpenter_tpu_torch.mesh import Mesh  # noqa: E402
from karpenter_tpu_torch.ops import delta as tdelta  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from torch_inputs import core_inputs, group_inputs, offering_inputs, onehot, to_torch  # noqa: E402

torch.set_num_threads(1)

SEEDS = range(12)


def _jax_group_args(args):
    """The reference takes the [O, I] owner one-hot where the port takes
    owner indices."""
    I = args[2].shape[1]
    return args[:6] + (onehot(args[6], I),) + args[7:]


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, (g.dtype, want.dtype, g.shape, want.shape)
    np.testing.assert_array_equal(g, want)


# -- B8 offering_reduce ------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_offering_reduce_plain_matches_jax(seed):
    args, I = offering_inputs(seed)
    want = jfeas.offering_reduce(*(jnp.asarray(a) for a in args[:5]), jnp.asarray(onehot(args[5], I)))
    n0 = tfeas.LAUNCHES["offering_reduce"]
    got = tfeas.offering_reduce(*(to_torch(a) for a in args), I)
    assert tfeas.LAUNCHES["offering_reduce"] == n0
    _same(got, want)
    # the cube's offering half is the same function
    cube = tfeas.production_cube_plain(
        to_torch(args[0]), torch.ones((args[0].shape[1], I), dtype=torch.bool),
        *(to_torch(a) for a in args[1:]),
    )
    assert torch.equal(cube[1], got)


# -- B9 / B10 solve_block ------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_solve_block_plain_matches_jax(seed):
    args = group_inputs(seed)
    jargs = tuple(jnp.asarray(a) for a in _jax_group_args(args))
    n0 = dict(tpacker.LAUNCHES)
    targs = tuple(to_torch(a) for a in args)
    _same(tpacker.solve_block(*targs), jpacker.solve_block_jit(*jargs))
    _same(tpacker.solve_block_core(*targs), jpacker.solve_block_core_jit(*jargs))
    assert tpacker.LAUNCHES == n0  # the plain versions launch nothing


def test_solve_block_edges_match_jax():
    """All-infeasible groups (choice 0, pods-per-node from type 0),
    zero-request groups (pods-per-node INT32_MAX) and exact price ties
    (the first index wins)."""
    args = list(group_inputs(6))  # G=16, group 0 fits nothing
    D = args[7].shape[1]
    args[1] = args[1].copy()
    args[1][1, :D] = 0  # requests nothing
    args[2] = np.ones_like(args[2])
    args[8] = np.full_like(args[8], 1.0)  # every price ties
    args = tuple(args)
    want = np.asarray(jpacker.solve_block_jit(*(jnp.asarray(a) for a in _jax_group_args(args))))
    got = tpacker.solve_block(*(to_torch(a) for a in args))
    _same(got, want)
    assert want[0, 1] == 0 and want[0, 0] == 0  # group 0 fits nothing
    core = tpacker.solve_block_core(*(to_torch(a) for a in args))
    _same(core, jpacker.solve_block_core_jit(*(jnp.asarray(a) for a in _jax_group_args(args))))


# -- B11 / B12 the delta kernels ------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_delta_scatter_and_finalize_plain_match_jax(seed):
    core, slots, rows, order, counts = core_inputs(seed)
    want = np.asarray(jpacker.delta_scatter_rows(jnp.asarray(core), jnp.asarray(slots), jnp.asarray(rows)))
    t_core = to_torch(core.copy())
    got = tpacker.delta_scatter_rows(t_core, to_torch(slots), to_torch(rows))
    assert got is t_core  # in place
    _same(got, want)
    want_f = jpacker.delta_finalize(jnp.asarray(want), jnp.asarray(order), jnp.asarray(counts))
    _same(tpacker.delta_finalize(got, to_torch(order), to_torch(counts)), want_f)


def test_group_core_from_numpy():
    core = core_inputs(1)[0]
    t = convert.group_core_from_numpy(core, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), core)
    with pytest.raises(ValueError):
        convert.group_core_from_numpy(core[:, :2], "cpu")


def test_group_wrappers_refuse_other_devices():
    args = [to_torch(a).to("meta") for a in group_inputs(0)]
    with pytest.raises(ValueError):
        tpacker.solve_block(*args)


# -- GroupSolver, full and delta ------------------------------------------------------

ZONES = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def build_shapes(pkg: str, n: int = 10):
    """tests/test_delta.py's value-stable requirement shapes, fresh objects
    every call, in either package's API."""
    wk = _m(pkg, "apis.labels")
    rq = _m(pkg, "scheduling.requirements")
    shapes = []
    for i in range(n):
        reqs = rq.Requirements(rq.Requirement(wk.LABEL_OS, rq.Operator.IN, ["linux"]))
        if i % 2:
            reqs.add(rq.Requirement(wk.LABEL_ARCH, rq.Operator.IN, ["amd64"]))
        if i % 3 == 0:
            reqs.add(rq.Requirement(wk.LABEL_TOPOLOGY_ZONE, rq.Operator.IN, [ZONES[i % 4]]))
        shapes.append(reqs)
    return shapes


def churn_batch(pkg: str, engine, rng, shapes, pods: int):
    wk = _m(pkg, "apis.labels")
    picks = rng.randint(len(shapes), size=pods)
    requests = np.zeros((pods, len(engine.resource_dims)), dtype=np.float64)
    requests[:, engine.resource_dims[wk.RESOURCE_CPU]] = rng.choice([0.1, 0.5, 1.0, 2.0], size=pods)
    requests[:, engine.resource_dims[wk.RESOURCE_MEMORY]] = rng.choice([128, 512, 1024], size=pods) * 2**20
    requests[:, engine.resource_dims[wk.RESOURCE_PODS]] = 1.0
    return [shapes[i] for i in picks], requests


def engine_for(pkg: str):
    catalog = _m(pkg, "cloudprovider.kwok.instance_types").construct_instance_types()
    kw = {"device": "cpu"} if pkg == "karpenter_tpu_torch" else {}
    return _m(pkg, "ops.catalog").CatalogEngine(catalog, **kw)


@pytest.fixture
def delta_both():
    """Delta solves on in both packages (self-check every 4 warm passes),
    every residency dropped before and after."""
    saved = [(mod, mod.DELTA_MODE, mod.RESOLVE_FULL_EVERY) for mod in (jdelta, tdelta)]
    for mod in (jdelta, tdelta):
        mod.configure(mode="on", resolve_full_every=4)
        mod.invalidate_all("test-setup")
    yield
    for mod, mode, every in saved:
        mod.configure(mode=mode, resolve_full_every=every)
        mod.invalidate_all("test-teardown")


def _grouped_fields(g):
    return tuple(getattr(g, f) for f in ("membership", "requests_q", "key_present", "counts", "group_of_pod"))


@pytest.mark.parametrize("seed", range(4))
def test_group_solver_full_matches_jax(seed):
    """The same batch encoded and solved by both packages' GroupSolver
    (delta off): the encode and all four outputs equal exactly."""
    out = {}
    for pkg in ("karpenter_tpu", "karpenter_tpu_torch"):
        engine = engine_for(pkg)
        rng = np.random.RandomState(40 + seed)
        reqs, requests = churn_batch(pkg, engine, rng, build_shapes(pkg, 6 + seed), 50 + 40 * seed)
        grouped = _m(pkg, "ops.packer").encode_pods_for_packer(engine, reqs, requests)
        solver = _m(pkg, "ops.packer").GroupSolver(engine)
        out[pkg] = (_grouped_fields(grouped), solver.solve(grouped))
    (jg, jres), (tg, tres) = out["karpenter_tpu"], out["karpenter_tpu_torch"]
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jres, tres):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tres[0].size and tres[1].any()


def test_group_solver_delta_stream_matches_jax(delta_both):
    """One churn stream through both packages' delta GroupSolver: every
    pass's outputs, cold/warm mode and solved/reused group counts equal
    the reference's, and equal the port's own from-scratch solve."""
    seen = {}
    for pkg, dmod in (("karpenter_tpu", jdelta), ("karpenter_tpu_torch", tdelta)):
        engine = engine_for(pkg)
        packer = _m(pkg, "ops.packer")
        solver = packer.GroupSolver(engine)
        res = dmod.group_residency(solver)
        rng = np.random.RandomState(21)
        trace = []
        for p in range(7):
            shapes = build_shapes(pkg, 8 + (p % 3))
            reqs, requests = churn_batch(pkg, engine, rng, shapes, 60 + 20 * p)
            c0 = dmod.delta_counters()
            grouped = packer.encode_pods_for_packer(engine, reqs, requests)
            got = solver.solve(grouped)
            c1 = dmod.delta_counters()
            full = solver._solve_full(grouped)
            for a, b in zip(got, full):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            trace.append((
                res.last_mode,
                c1["delta_groups_solved"] - c0["delta_groups_solved"],
                c1["delta_groups_reused"] - c0["delta_groups_reused"],
                tuple(np.asarray(a).tobytes() for a in got),
            ))
        seen[pkg] = trace
        del solver, engine
    assert seen["karpenter_tpu_torch"] == seen["karpenter_tpu"]
    assert any(t[0] == "warm" for t in seen["karpenter_tpu_torch"])


def test_group_solver_with_a_mesh_raises(monkeypatch):
    """A mesh of another device type than the engine's is refused (a mesh
    of the engine's type solves sharded: tests/test_torch_mesh.py)."""
    engine = engine_for("karpenter_tpu_torch")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="mesh of cuda devices"):
        tpacker.GroupSolver(engine, mesh=Mesh([torch.device("cuda", 0)]))


def test_group_residency_core_is_resident_int32(delta_both):
    engine = engine_for("karpenter_tpu_torch")
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(5)
    reqs, requests = churn_batch("karpenter_tpu_torch", engine, rng, build_shapes("karpenter_tpu_torch"), 80)
    solver.solve(tpacker.encode_pods_for_packer(engine, reqs, requests))
    res = tdelta.group_residency(solver)
    assert res.core.dtype == torch.int32 and tuple(res.core.shape) == (res.cap, 3)
    assert res.core.device == engine.device
    assert res.resident_bytes() == res.cap * 12

