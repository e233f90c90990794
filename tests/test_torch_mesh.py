"""The port's solver mesh (karpenter_tpu_torch/mesh.py and the sharded twins
in ops/feasibility.py, ops/packer.py, ops/fused.py) against the JAX
package's, on the CPU.

The JAX package runs on the 8 virtual CPU devices tests/conftest.py makes;
the port's mesh repeats the CPU device (`Mesh([cpu] * n)`), so every shard
runs the plain torch versions. At mesh sizes 1, 2 and 8 the same
numpy-seeded inputs go through both: the sharded cube (B5), the engine's
sweep (planes and the padded entity shape), the sharded group solve (B13,
groups that do not divide the mesh, shards of padding only) and the fused
scan's replicated twins (B17, classic and with delta solves). Every
comparison is exact: the outputs are bools and ints, and the solves must
decide the same. The JAX scan runs under real float64 (`packer.scan_x64`
monkeypatched, as tests/test_torch_scan.py explains).
"""

from __future__ import annotations

import itertools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import catalog as jcatalog  # noqa: E402
from karpenter_tpu.ops import delta as jdelta  # noqa: E402
from karpenter_tpu.ops import feasibility as jfeas  # noqa: E402
from karpenter_tpu.ops import ffd as jffd  # noqa: E402
from karpenter_tpu.ops import fused as jfused  # noqa: E402
from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu.aot import ladder as jladder  # noqa: E402
from karpenter_tpu.scheduler import nodeclaim as jnodeclaim  # noqa: E402
from karpenter_tpu_torch import mesh as tmesh  # noqa: E402
from karpenter_tpu_torch.mesh import Mesh  # noqa: E402
from karpenter_tpu_torch.ops import delta as tdelta  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import ffd as tffd  # noqa: E402
from karpenter_tpu_torch.ops import fused as tfused  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim  # noqa: E402
from test_torch_delta import JAX, PORT, PkgEnv, _m, _x64, canon, plain_pods  # noqa: E402
from torch_inputs import onehot, to_torch  # noqa: E402

torch.set_num_threads(1)

SIZES = [1, 2, 8]
CPU = torch.device("cpu")


def jmesh(n: int) -> JMesh:
    return JMesh(np.array(jax.devices("cpu")[:n]), ("pods",))


def tmesh_of(n: int) -> Mesh:
    return Mesh([CPU] * n)


def mesh_for(pkg: str, n: int):
    return jmesh(n) if pkg == JAX else tmesh_of(n)


def engine(pkg: str, catalog, n=None):
    kw = {"device": "cpu"} if pkg == PORT else {}
    if n is not None:
        kw["mesh"] = mesh_for(pkg, n)
    return _m(pkg, "ops.catalog").CatalogEngine(catalog, **kw)


def workload(pkg: str, pods: int = 500, seed: int = 3):
    """tests/test_mesh.py's shape-diverse batch against the kwok catalog,
    in either package."""
    wk = _m(pkg, "apis.labels")
    rq = _m(pkg, "scheduling.requirements")
    catalog = _m(pkg, "cloudprovider.kwok.instance_types").construct_instance_types()
    dims = engine(pkg, catalog).resource_dims
    rng = np.random.RandomState(seed)
    zones = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
    shapes = []
    for i in range(20):
        reqs = rq.Requirements(rq.Requirement(wk.LABEL_OS, rq.Operator.IN, ["linux"]))
        if i % 2:
            reqs.add(rq.Requirement(wk.LABEL_ARCH, rq.Operator.IN, ["amd64"]))
        if i % 3 == 0:
            reqs.add(rq.Requirement(wk.LABEL_TOPOLOGY_ZONE, rq.Operator.IN, [zones[i % 4]]))
        shapes.append(reqs)
    picks = rng.randint(len(shapes), size=pods)
    requests = np.zeros((pods, len(dims)))
    requests[:, dims[wk.RESOURCE_CPU]] = rng.choice([0.1, 0.5, 1.0, 2.0], size=pods)
    requests[:, dims[wk.RESOURCE_MEMORY]] = rng.choice([128, 512, 1024], size=pods) * 2**20
    requests[:, dims[wk.RESOURCE_PODS]] = 1.0
    return catalog, shapes, [shapes[i] for i in picks], requests


@pytest.fixture
def force_device(monkeypatch):
    """The reference's sweep pinned to its device programs (its adaptive
    routing would send these small cubes to the numpy twins)."""
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")


# -- mesh.py: alignment, scope, construction -------------------------------------


def test_mesh_multiple_matches_reference():
    for n in (1, 2, 3, 4, 5, 8, 12, 16, 24):
        assert tmesh.mesh_multiple(n) == jladder.mesh_multiple(n)
    assert tmesh.MESH_ALIGN == jladder.MESH_ALIGN
    assert [tmesh.mesh_multiple(n) for n in (1, 2, 8, 3, 16)] == [8, 8, 8, 24, 16]


@pytest.mark.parametrize("n", SIZES)
def test_mesh_scope_matches_reference(n):
    assert tfeas.mesh_scope(tmesh_of(n)) == jfeas.mesh_scope(jmesh(n)) == f"mesh={n}:pods"
    assert tmesh_of(n).shape == dict(jmesh(n).shape)


def test_mesh_construction():
    m = Mesh(["cpu", CPU, torch.device("cpu")])
    assert m.size == 3 and m.shape == {"pods": 3} and m.axis_names == ("pods",)
    assert m.devices == (CPU,) * 3
    with pytest.raises(ValueError):
        Mesh([])
    with pytest.raises(ValueError):
        Mesh([CPU], axis_names=("pods", "types"))
    with pytest.raises(ValueError):
        Mesh(["meta"])


def test_build_solver_mesh_semantics(monkeypatch):
    """The reference's _build_solver_mesh: off below 1, None with a warning
    when the machine has fewer devices than asked, else the first n CUDA
    devices, never one repeated."""
    assert tmesh.build_solver_mesh(0) is None and tmesh.build_solver_mesh(-1) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmesh.build_solver_mesh(1) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA H100 80GB HBM3")
    one = tmesh.build_solver_mesh(1)
    assert one.size == 1 and one.devices == (torch.device("cuda", 0),)
    eight = tmesh.build_solver_mesh(8)
    assert eight.devices == tuple(torch.device("cuda", i) for i in range(8))
    assert len(set(eight.devices)) == 8
    assert tmesh.build_solver_mesh(4096) is None  # shortfall: warn, run unsharded


def test_group_solver_inherits_engine_mesh():
    catalog = workload(PORT)[0]
    mesh = tmesh_of(2)
    eng = engine(PORT, catalog, 2)
    assert tpacker.GroupSolver(eng).mesh is eng.mesh
    assert tpacker.GroupSolver(eng, mesh=mesh).mesh is mesh  # an explicit mesh wins
    plain = engine(PORT, catalog)
    assert plain.mesh is None and tpacker.GroupSolver(plain).mesh is None
    assert tpacker.GroupSolver(plain, mesh=mesh).mesh is mesh


def test_replicate_and_split_helpers():
    m = tmesh_of(4)
    t = torch.arange(8).reshape(8, 1)
    reps = tmesh.replicate(t, m)
    assert len(reps) == 4 and all(r is t for r in reps)  # one device: no copy
    assert tmesh.per_shard(reps, m) is reps
    with pytest.raises(ValueError):
        tmesh.per_shard(reps[:3], m)
    slabs = tmesh.split_rows(t, m)
    assert [s.flatten().tolist() for s in slabs] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert torch.equal(tmesh.gather_rows(slabs, m), t)
    with pytest.raises(ValueError):
        tmesh.split_rows(torch.zeros(6, 1), m)


def test_replicas_are_checked_where_made():
    """replicate makes contiguous copies; per_shard takes a Replicas as it
    is and holds a plain tuple's copies to one dtype, shape and layout."""
    m = tmesh_of(2)
    t = torch.arange(12).reshape(3, 4).T  # not contiguous
    reps = tmesh.replicate(t, m)
    assert isinstance(reps, tmesh.Replicas) and reps[0] is reps[1]
    assert reps[0].is_contiguous() and torch.equal(reps[0], t)
    plain = (torch.zeros(3), torch.zeros(3))
    got = tmesh.per_shard(plain, m)
    assert isinstance(got, tmesh.Replicas) and got[0] is plain[0] and got[1] is plain[1]
    for bad in ((torch.zeros(3), torch.zeros(4)), (torch.zeros(3), torch.zeros(3, dtype=torch.int32)),
                (torch.zeros(3), torch.zeros(6)[::2])):
        with pytest.raises(ValueError):
            tmesh.per_shard(bad, m)


# device lists of every mesh size the tests use, cards repeated in several
# ways (torch.device("cuda", k) needs no card to exist)
def _cards(*idx):
    return [torch.device("cuda", k) for k in idx]


PLAN_DEVICES = {
    1: [_cards(0)],
    2: [_cards(0, 0), _cards(0, 1), _cards(1, 0)],
    3: [_cards(0, 0, 0), _cards(0, 1, 2), _cards(0, 1, 0), _cards(1, 0, 0)],
    8: [_cards(*range(8)), _cards(*[0] * 8), _cards(0, 1) * 4, _cards(*[0] * 4, *[1] * 4)],
}


def _padded(count: int, n: int) -> int:
    """The engine's padded entity axis: the pow2 bucket aligned to
    mesh_multiple(n) (CatalogEngine.feasibility, GroupSolver.solve_sharded)."""
    align = tmesh.mesh_multiple(n)
    p2 = max(1 << max(0, (count - 1).bit_length()), align)
    return -(-p2 // align) * align


@pytest.mark.parametrize("n", sorted(PLAN_DEVICES))
@pytest.mark.parametrize("count", [1, 3, 8, 20, 200])
def test_slab_plan_groups_shards_by_card(n, count):
    """slab_plan on padded entity axes: every shard once, on its own
    device, in shard order within its card; cards in order of first
    appearance; rows covering the axis exactly; the shards past the real
    entities made of padding only; and card_runs merging adjacent shards
    into one run per card when the card's shards are adjacent."""
    rows = _padded(count, n)
    assert rows % n == 0
    m = rows // n
    for devices in PLAN_DEVICES[n]:
        plan = tmesh.slab_plan(devices, rows)
        assert [d for d, _ in plan] == list(dict.fromkeys(devices))
        shards = sorted(sl for _, slabs in plan for sl in slabs)
        assert shards == [(s, s * m, (s + 1) * m) for s in range(n)]
        for dev, slabs in plan:
            assert [s for s, _, _ in slabs] == [s for s, d in enumerate(devices) if d == dev]
            runs = tmesh.card_runs(slabs)
            assert sum(hi - lo for lo, hi, _ in runs) == len(slabs) * m
            assert [c for _, _, c in runs] == list(itertools.accumulate(
                [0] + [hi - lo for lo, hi, _ in runs[:-1]]))
            adjacent = all(b[0] == a[0] + 1 for a, b in zip(slabs, slabs[1:]))
            assert (len(runs) == 1) == adjacent
        padding_only = [s for s in range(n) if s * m >= count]
        assert len(padding_only) == max(0, n - -(-count // m))
    with pytest.raises(ValueError):
        tmesh.slab_plan([], rows)
    if n > 1:
        with pytest.raises(ValueError):
            tmesh.slab_plan(PLAN_DEVICES[n][0], rows + 1)


@pytest.mark.parametrize("n", sorted(PLAN_DEVICES))
def test_slab_layout_reassembles_the_rows(n):
    """The sharded wrappers' layout on the card, with CPU tensors standing
    in for the cards: the first card writes its shards at their own rows,
    every other card into its compact rows (stage_rows' starts), and
    gather_cards puts those back; the result is the whole axis in order,
    for every device list, padding-only shards included."""
    rows = _padded(3, n)
    x = torch.arange(rows * 2, dtype=torch.int32).reshape(rows, 2)
    for devices in PLAN_DEVICES[n]:
        plan = tmesh.slab_plan(devices, rows)
        out = torch.full_like(x, -1)
        others = []
        for k, (_, slabs) in enumerate(plan):
            (ptr,), starts, keep = tmesh.stage_rows((x,), slabs, CPU)  # in place
            assert ptr == x.data_ptr() and keep is None and starts == [lo for _, lo, _ in slabs]
            if k == 0:
                for _, lo, hi in slabs:
                    out[lo:hi] = x[lo:hi]
            else:
                others.append((slabs, torch.cat([x[lo:hi] for _, lo, hi in slabs])))
        tmesh.gather_cards(out, others)
        assert torch.equal(out, x)


@pytest.mark.parametrize("n", sorted(PLAN_DEVICES))
def test_staging_buffer_holds_each_cards_rows(n):
    """The host side of one card's upload: staging_layout places each
    entity operand 16-byte aligned, and fill_staging writes the card's rows
    of each, shard after shard, byte for byte as the kernels read them
    (bool rows, int32 rows, a zero-width operand)."""
    rows = _padded(5, n)
    rng = np.random.RandomState(n)
    bools = torch.from_numpy(rng.rand(rows, 15) < 0.5)
    ints = torch.from_numpy(rng.randint(-9, 9, size=(rows, 5)).astype(np.int32))
    empty = torch.zeros((rows, 0), dtype=torch.bool)
    tensors = (bools, ints, empty)
    for devices in PLAN_DEVICES[n]:
        for _, slabs in tmesh.slab_plan(devices, rows):
            count = sum(hi - lo for _, lo, hi in slabs)
            offsets, total = tmesh.staging_layout(tensors, count)
            assert all(o % 16 == 0 for o in offsets) and total % 16 == 0
            assert total >= offsets[-1] and offsets[1] >= count * 15
            buf = np.full(total, 0xAB, dtype=np.uint8)
            tmesh.fill_staging(buf, tensors, tmesh.card_runs(slabs), offsets)
            for t, off in zip(tensors, offsets):
                want = torch.cat([t[lo:hi] for _, lo, hi in slabs]).numpy()
                size = want.nbytes
                got = buf[off:off + size].view(want.dtype).reshape(want.shape)
                np.testing.assert_array_equal(got, want)


# -- B5: the sharded cube ---------------------------------------------------------


def cube_case(seed: int):
    rng = np.random.RandomState(300 + seed)
    P = (8, 16, 24)[seed % 3]
    R, I, O, K = (4, 33, 70, 8) if seed % 2 else (8, 7, 20, 8)
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


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", range(3))
def test_sharded_cube_matches_jax(n, seed):
    args = cube_case(seed)
    I = args[1].shape[1]
    jargs = [jnp.asarray(a) for a in args[:6]] + [jnp.asarray(onehot(args[6], I))]
    want_c, want_o = (np.asarray(x) for x in jfeas.sharded_cube(jmesh(n))(*jargs))
    tfeas.reset_launch_counts()
    got_c, got_o = tfeas.sharded_cube(tmesh_of(n))(*(to_torch(a) for a in args))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_o.numpy(), want_o)
    # and the unsharded cube on the same inputs
    plain_c, plain_o = tfeas.production_cube(*(to_torch(a) for a in args))
    assert torch.equal(plain_c, got_c) and torch.equal(plain_o, got_o)
    assert not any(tfeas.LAUNCHES.values())  # CPU shards launch nothing


def _record(calls: list, real_factory, shape_of):
    """A factory wrapper recording the input shape of every call of the
    callables it makes."""
    def factory(*a, **kw):
        fn = real_factory(*a, **kw)

        def run(*args):
            calls.append(shape_of(args))
            return fn(*args)

        return run

    return factory


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("count", [3, 20])
def test_engine_sweep_matches_jax_planes_and_padding(force_device, monkeypatch, n, count):
    """CatalogEngine.feasibility on a mesh: the same planes as the JAX
    engine on a mesh of the same size, and the same padded global entity
    axis (pow2 aligned to lcm(n, 8))."""
    seen = {}
    for pkg, fmod in ((JAX, jfeas), (PORT, tfeas)):
        calls = []
        monkeypatch.setattr(fmod, "sharded_cube", _record(calls, fmod.sharded_cube,
                                                           lambda a: tuple(a[0].shape)))
        catalog, shapes = workload(pkg)[:2]
        shapes = (shapes * 2)[:count]
        eng = engine(pkg, catalog, n)
        rows = [eng.rows_for(r) for r in shapes]
        zero = np.zeros((len(shapes), len(eng.resource_dims)))
        f = eng.feasibility(rows, zero, eng.key_presence(shapes))
        seen[pkg] = (f.compat, f.fits, f.has_offering, calls)
    for a, b in zip(seen[PORT][:3], seen[JAX][:3]):
        np.testing.assert_array_equal(a, b)
    assert seen[PORT][3] == seen[JAX][3] and len(seen[PORT][3]) == 1
    P2 = seen[PORT][3][0][0]
    assert P2 % n == 0 and P2 == max(8, 1 << (count - 1).bit_length())
    # a 1-device mesh, and every size, equals the unsharded port
    catalog, shapes = workload(PORT)[:2]
    shapes = (shapes * 2)[:count]
    plain = engine(PORT, catalog)
    rows = [plain.rows_for(r) for r in shapes]
    f0 = plain.feasibility(rows, np.zeros((count, len(plain.resource_dims))), plain.key_presence(shapes))
    np.testing.assert_array_equal(f0.feasible, seen[PORT][0] & seen[PORT][1] & seen[PORT][2])


def test_membership_only_engine_stays_unsharded(monkeypatch):
    """A catalog without offerings takes the unsharded membership sweep, as
    in the reference."""
    InstanceType = _m(PORT, "cloudprovider.types").InstanceType
    catalog = [
        InstanceType(name=it.name, requirements=it.requirements, offerings=[],
                     capacity=it.capacity, overhead=it.overhead)
        for it in workload(PORT)[0][:4]
    ]
    eng = engine(PORT, catalog, 2)
    assert eng.num_offerings == 0
    called = []
    monkeypatch.setattr(tfeas, "sharded_cube", lambda mesh: called.append(mesh))
    rows = [eng.rows_for(workload(PORT)[1][0])]
    f = eng.feasibility(rows, np.zeros((1, len(eng.resource_dims))))
    assert not called and f.compat.shape == (1, 4) and not f.has_offering.any()


# -- B13: the sharded group solve --------------------------------------------------


def group_solve(pkg, n, pods=500, calls=None):
    catalog, _, reqs, requests = workload(pkg, pods)
    eng = engine(pkg, catalog, n)
    grouped = _m(pkg, "ops.packer").encode_pods_for_packer(eng, reqs, requests)
    return grouped, _m(pkg, "ops.packer").GroupSolver(eng).solve(grouped)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("pods", [500, 3])
def test_sharded_group_solve_matches_jax(monkeypatch, n, pods):
    """GroupSolver.solve on a mesh engine against the JAX solve_sharded: a
    group count no mesh size divides (500 pods), and 3 groups (on 8 shards
    five are padding only). Results and the padded group axis equal."""
    seen = {}
    for pkg, pmod in ((JAX, jpacker), (PORT, tpacker)):
        calls = []
        monkeypatch.setattr(pmod, "sharded_solve_block", _record(
            calls, pmod.sharded_solve_block, lambda a: (tuple(a[0].shape), tuple(a[1].shape))))
        grouped, out = group_solve(pkg, n, pods)
        seen[pkg] = (grouped.membership.shape[0], tuple(np.asarray(a).tobytes() for a in out),
                     [np.asarray(a).dtype for a in out], calls)
    assert seen[PORT] == seen[JAX]
    G, calls = seen[PORT][0], seen[PORT][3]
    assert len(calls) == 1
    G2 = calls[0][0][0]
    assert G2 % n == 0 and G2 >= G and G2 == max(8, 1 << (G - 1).bit_length())
    if pods == 500:
        assert G % 8, "the workload must exercise padding"
    # the unsharded port decides the same
    catalog, _, reqs, requests = workload(PORT, pods)
    eng = engine(PORT, catalog)
    base = tpacker.GroupSolver(eng).solve(tpacker.encode_pods_for_packer(eng, reqs, requests))
    assert tuple(np.asarray(a).tobytes() for a in base) == seen[PORT][1]


def test_sharded_group_solve_bypasses_the_group_residency():
    """With a mesh the solve takes solve_sharded ahead of the delta check:
    no group residency is built, as in the reference."""
    saved = (tdelta.DELTA_MODE, tdelta.RESOLVE_FULL_EVERY)
    tdelta.configure(mode="on")
    tdelta.invalidate_all("test-setup")
    try:
        catalog, _, reqs, requests = workload(PORT, 200)
        eng = engine(PORT, catalog, 2)
        solver = tpacker.GroupSolver(eng)
        out = solver.solve(tpacker.encode_pods_for_packer(eng, reqs, requests))
        assert out[1].any()
        assert tdelta.group_residency(solver).core is None
    finally:
        tdelta.configure(mode=saved[0], resolve_full_every=saved[1])
        tdelta.invalidate_all("test-teardown")


# -- B17: the replicated scan through a fused solve ---------------------------------


@pytest.fixture
def fused_mesh(monkeypatch):
    """Both packages with the fused scan forced on, the JAX scan in real
    float64, delta solves off unless a test turns them on (then a
    self-check every 2 warm passes), fresh name counters, every residency
    dropped before and after."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr(jfused, "FUSED_MODE", "on")
    monkeypatch.setattr(tfused, "FUSED_MODE", "on")
    for mod in (jnodeclaim, tnodeclaim):
        monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
    for mod in (jffd, tffd):
        monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))
    saved = [(mod, mod.DELTA_MODE, mod.RESOLVE_FULL_EVERY) for mod in (jdelta, tdelta)]
    for mod in (jdelta, tdelta):
        mod.configure(mode="off", resolve_full_every=2)
        mod.invalidate_all("test-setup")
    yield
    for mod, mode, every in saved:
        mod.configure(mode=mode, resolve_full_every=every)
        mod.invalidate_all("test-teardown")


def mesh_env(pkg: str, n):
    env = PkgEnv(pkg)
    if n is not None:
        env.engine = engine(pkg, env.its["default"], n)
    return env


@pytest.fixture
def replicas(monkeypatch):
    """Every replica's outputs of the port's replicated scans, per call."""
    seen = []
    real = tpacker.replicate_scan

    def shim(mesh, mode, *a, **kw):
        outs = real(mesh, mode, *a, **kw)
        seen.append((mode, mesh.size, outs))
        return outs

    monkeypatch.setattr(tpacker, "replicate_scan", shim)
    return seen


def _assert_replicas_agree(seen) -> None:
    for mode, n, outs in seen:
        assert len(outs) == n
        for out in outs[1:]:
            for a, b in zip(out, outs[0]):
                assert a.dtype == b.dtype and torch.equal(a, b), mode


MIXED = ("250m", "500m", "1", "2")


@pytest.mark.parametrize("n", SIZES)
def test_fused_mesh_classic_matches_jax(fused_mesh, replicas, n):
    """The classic fused solve on a mesh engine (sharded_solve_scan)
    against the JAX fusedmesh leg; and against the unsharded port."""
    f0 = tfused.FUSED_SOLVES
    got = {pkg: canon(mesh_env(pkg, n).schedule(plain_pods(pkg, 96, cpus=MIXED))) for pkg in (JAX, PORT)}
    assert tfused.FUSED_SOLVES == f0 + 1
    assert got[PORT] == got[JAX] and not got[PORT][1]
    assert [(m, k) for m, k, _ in replicas] == [("classic", n)]
    _assert_replicas_agree(replicas)
    assert canon(mesh_env(PORT, None).schedule(plain_pods(PORT, 96, cpus=MIXED))) == got[PORT]


STREAM = [
    lambda pkg: plain_pods(pkg, 64, cpus=("1",)),
    lambda pkg: plain_pods(pkg, 80, cpus=("1",)),
    lambda pkg: plain_pods(pkg, 80, cpus=("1",)),
    lambda pkg: plain_pods(pkg, 90, cpus=("1",)),
    lambda pkg: plain_pods(pkg, 90, cpus=("500m", "1")),
    lambda pkg: plain_pods(pkg, 90, cpus=("500m", "1")) + plain_pods(pkg, 3, cpus=("2",), prefix="big"),
]


def delta_stream(pkg: str, n):
    env = mesh_env(pkg, n)
    out = []
    for make in STREAM:
        r = env.schedule(make(pkg))
        out.append((env.residency.last_outcome, canon(r)))
    return env, out


@pytest.mark.parametrize("n", SIZES)
def test_fused_mesh_delta_matches_jax(fused_mesh, replicas, n):
    """Delta solves on a mesh engine (sharded_solve_scan_full/_resume): the
    outcome sequence (cold, warm, miss reasons) and the decisions of every
    pass equal the reference's on a mesh of the same size, the self-check
    agrees, the counters move alike; every replica holds its own state,
    and every replica's outputs agree."""
    for mod in (jdelta, tdelta):
        mod.configure(mode="on")
    c0 = {mod: mod.delta_counters() for mod in (jdelta, tdelta)}
    _, want = delta_stream(JAX, n)
    env, got = delta_stream(PORT, n)
    assert got == want
    outcomes = [o for o, _ in got]
    assert outcomes[:4] == ["cold", "warm", "warm", "warm"], outcomes
    moved = {
        mod: {k: v - c0[mod].get(k, 0) for k, v in mod.delta_counters().items()
              if k.startswith(("delta_scan", "delta_selfchecks", "delta_passes", "delta_rows"))
              and v != c0[mod].get(k, 0)}
        for mod in (jdelta, tdelta)
    }
    assert moved[jdelta] == moved[tdelta]
    assert moved[tdelta]["delta_selfchecks_identical"] >= 1
    res = env.residency
    states = res.replica_states()
    assert len(states) == n and states[0] is res.state
    assert len({id(t) for st in states for t in st}) == n * len(tpacker.SCAN_STATE_FIELDS)
    single = sum(t.numel() * t.element_size() for t in res.state)
    assert res.resident_bytes() == n * single
    modes = {m for m, _, _ in replicas}
    assert modes == {"full", "resume"} and all(k == n for _, k, _ in replicas)
    _assert_replicas_agree(replicas)
    # the unsharded port takes the same outcomes and decisions
    for mod in (tdelta,):
        mod.invalidate_all("test-unsharded")
    assert delta_stream(PORT, None)[1] == got
