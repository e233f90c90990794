"""The catalog engine's host route against the JAX package's, on the CPU.

The reference (karpenter_tpu/ops/catalog.py) weighs each row batch and each
sweep: its host cost in cells over a host rate, against the device's
measured round trip (`device_rtt_s`), and runs the small ones through exact
numpy twins, counted with `record_host`. The port (karpenter_tpu_torch/
ops/catalog.py) carries the same constants and decisions, its round trip
measured on the engine's own torch device. Here:

1. the three numpy twins, the port's against the reference's and against
   the port's plain kernel versions, bit for bit;
2. `_use_device`, and the two routing sites (`_ensure_rows`,
   `feasibility()`), over a grid of shapes, pinned round trips,
   FORCE_BACKEND pins, delta on and off, a mesh or none, and a catalog with
   or without offerings: the same decisions, the same host records under
   the same shape buckets, the same device dispatches (one row dispatch a
   batch in the port where the reference makes two), the same results;
3. a host row batch's rows reach the resident device matrices, so a device
   sweep after it equals the plain path;
4. a probe that fails is a KernelError and is never cached;
5. the reference's host/device twin cases and its observatory's sim
   report case, on both packages (tests/torch_twins.py).
"""

from __future__ import annotations

import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import catalog as jcat  # noqa: E402
from karpenter_tpu.ops import feasibility as jfeas  # noqa: E402
from karpenter_tpu_torch.device import KernelError  # noqa: E402
from karpenter_tpu_torch.ops import catalog as tcat  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from test_torch_catalog import build_catalog, build_queries  # noqa: E402
from test_torch_delta import JAX, PORT, _m  # noqa: E402
from torch_inputs import (  # noqa: E402
    MEMBERSHIP_EDGE_CASES,
    MEMBERSHIP_OK_FILLS,
    cube_inputs,
    membership_edge_inputs,
    offering_inputs,
    row_inputs,
    to_torch,
)
import torch_twins as tw  # noqa: E402

torch.set_num_threads(1)

SEEDS = range(8)
CAT = {JAX: jcat, PORT: tcat}

# -- 1. the numpy twins ----------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_row_twin_matches_the_reference_and_the_plain_version(seed):
    args = row_inputs(seed)
    got = tfeas.req_rows_vs_sets_np(*args)
    assert got.dtype == np.bool_ and got.shape == (args[0].shape[0], args[6].shape[0])
    np.testing.assert_array_equal(got, jfeas.req_rows_vs_sets_np(*args))
    plain = tfeas.req_rows_vs_sets_plain(*(to_torch(a) for a in args))
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_membership_twin_matches_the_reference_and_the_plain_version(seed):
    membership, row_ok = cube_inputs(seed)[:2]
    got = tfeas.membership_all_np(membership, row_ok)
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, jfeas.membership_all_np(membership, row_ok))
    plain = tfeas.membership_all_plain(to_torch(membership), to_torch(row_ok))
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("fill", MEMBERSHIP_OK_FILLS)
@pytest.mark.parametrize("case", MEMBERSHIP_EDGE_CASES)
def test_membership_twin_on_the_kernels_edges(case, fill):
    """kt_membership's instance edges (R on either side of 16, past 32, R
    = 0, P = 1, N = 1), a random, an all-false and an all-true row_ok."""
    membership, row_ok = membership_edge_inputs(case, fill)
    got = tfeas.membership_all_np(membership, row_ok)
    np.testing.assert_array_equal(got, jfeas.membership_all_np(membership, row_ok))
    plain = tfeas.membership_all_plain(to_torch(membership), to_torch(row_ok))
    np.testing.assert_array_equal(got, plain.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_offering_twin_matches_the_reference_and_the_plain_version(seed):
    args, I = offering_inputs(seed)
    got = tfeas.offering_reduce_np(*args, I)
    assert got.dtype == np.bool_ and got.shape == (args[0].shape[0], I)
    np.testing.assert_array_equal(got, jfeas.offering_reduce_np(*args, I))
    plain = tfeas.offering_reduce_plain(*(to_torch(a) for a in args), I)
    np.testing.assert_array_equal(got, plain.numpy())


# -- 2. the decisions ------------------------------------------------------------------

RTTS = (1e-6, 1e-4, 1e-2)
FORCES = (None, "device", "host")


@pytest.fixture
def pins(monkeypatch):
    """set(rtt, force): the same pinned round trip and FORCE_BACKEND in
    both packages (restored after the test)."""

    def set_(rtt, force):
        for mod in (jcat, tcat):
            monkeypatch.setattr(mod, "PINNED_RTT", rtt)
            monkeypatch.setattr(mod, "FORCE_BACKEND", force)

    return set_


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("rtt", RTTS)
def test_use_device_decides_as_the_reference(pins, rtt, force):
    pins(rtt, force)
    cells = (0, 1, 1e3, 2e5, 2e5 + 1, 5e7, 1e10)
    for c, rate in itertools.product(cells, (tcat._HOST_MATMUL_CELLS_PER_S, tcat._HOST_ROW_CELLS_PER_S)):
        assert tcat._use_device(c, rate, "cpu") == jcat._use_device(c, rate), (c, rate)


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("rtt", (None,) + RTTS)
def test_cuda_engine_routes_by_the_model_only_under_a_pin(monkeypatch, rtt, force):
    """A CUDA engine's decisions, made here without a card: unpinned, every
    batch stays on the card and no probe runs; under FORCE_BACKEND or a
    pinned round trip, the reference's decision."""
    monkeypatch.setattr(tcat, "_RTT_CACHE", {})
    cuda = torch.device("cuda", 0)
    for mod in (jcat, tcat):
        monkeypatch.setattr(mod, "PINNED_RTT", rtt)
        monkeypatch.setattr(mod, "FORCE_BACKEND", force)
    assert tcat._card_keeps_work(cuda) == (rtt is None and force is None)
    assert not tcat._card_keeps_work("cpu")
    if rtt is None and force is None:
        for c in (0, 1, 1e10):
            assert tcat._use_device(c, tcat._HOST_ROW_CELLS_PER_S, cuda)
        assert tcat._RTT_CACHE == {}
        return
    for c, rate in itertools.product((0, 1e3, 2e5 + 1, 1e10),
                                     (tcat._HOST_MATMUL_CELLS_PER_S, tcat._HOST_ROW_CELLS_PER_S)):
        assert tcat._use_device(c, rate, cuda) == jcat._use_device(c, rate), (c, rate)


def test_cost_model_constants_are_the_reference_s():
    for name in ("_HOST_MATMUL_CELLS_PER_S", "_HOST_ROW_CELLS_PER_S", "DEVICE_MIN_ROW_BATCH",
                 "PINNED_RTT", "FORCE_BACKEND"):
        assert getattr(tcat, name) == getattr(jcat, name), name


def _catalog(pkg: str, offerings: bool):
    cat = build_catalog(pkg, 0)
    if offerings:
        return cat
    types = _m(pkg, "cloudprovider.types")
    return [
        types.InstanceType(name=it.name, requirements=it.requirements,
                           offerings=types.Offerings([]), capacity=it.capacity,
                           overhead=it.overhead)
        for it in cat
    ]


def _engine(pkg: str, offerings: bool, mesh: int):
    kw = {}
    if pkg == PORT:
        from karpenter_tpu_torch.mesh import Mesh

        kw["device"] = "cpu"
        if mesh:
            kw["mesh"] = Mesh([torch.device("cpu")] * mesh)
    elif mesh:
        import jax
        from jax.sharding import Mesh as JMesh

        kw["mesh"] = JMesh(np.array(jax.devices("cpu")[:mesh]), ("pods",))
    return CAT[pkg].CatalogEngine(_catalog(pkg, offerings), **kw)


def _fresh_rows(pkg: str, n: int, tag: str):
    """n distinct requirement rows no engine has seen (zone values)."""
    rq = _m(pkg, "scheduling.requirements")
    wk = _m(pkg, "apis.labels")
    return [
        rq.Requirement(wk.LABEL_TOPOLOGY_ZONE, rq.Operator.IN, [f"{tag}-z{i}", "kwok-zone-1"])
        for i in range(n)
    ]


ROW_BATCHES = (1, 7, 31, 32, 40)
SWEEP_ENTITIES = (1, 5, 24)


def _drive(pkg: str, offerings: bool, mesh: int):
    """Row batches of ROW_BATCHES fresh rows, then sweeps of
    SWEEP_ENTITIES requirement sets, on one engine of `pkg`: what each
    `_use_device` call weighed and decided, the registry's records by
    kernel (host records by shape bucket, device dispatches in all), the
    delta counters' appended rows and every result."""
    cat, kobs = CAT[pkg], _m(pkg, "observability.kernels")
    delta = _m(pkg, "ops.delta")
    decisions = []
    real = cat._use_device

    def spy(cells, rate, *device):
        out = real(cells, rate, *device)
        decisions.append((cells, rate, out))
        return out

    reg = kobs.registry()
    reg.reset()
    appended0 = delta.delta_counters().get("delta_rows_device_appended", 0)
    results = []
    engine = _engine(pkg, offerings, mesh)
    prev = cat._use_device
    cat._use_device = spy
    try:
        for k, n in enumerate(ROW_BATCHES):
            for r in _fresh_rows(pkg, n, f"b{k}"):
                engine.row_id(r)
            engine._ensure_rows()
            results.append(engine._req_compat[-n:].copy())
        queries = build_queries(pkg, 0, n=max(SWEEP_ENTITIES))
        D = len(engine.resource_dims)
        for P in SWEEP_ENTITIES:
            q = queries[:P]
            rows = [engine.rows_for(r) for r in q]
            f = engine.feasibility(rows, np.zeros((P, D)), engine.key_presence(q))
            results.append((f.compat, f.fits, f.has_offering))
    finally:
        cat._use_device = prev
    counts = {}
    for name, k in reg.counts_snapshot().items():
        shapes = k["shapes"]
        counts[name] = {
            "host": {s: ph["host"] for s, ph in shapes.items() if ph["host"]},
            "device": sum(ph[p] for ph in shapes.values() for p in ("warmup", "steady", "aot-warm")),
        }
    reg.reset()
    appended = delta.delta_counters().get("delta_rows_device_appended", 0) - appended0
    return decisions, counts, appended, results, engine


@pytest.mark.parametrize("offerings", [True, False], ids=["offerings", "no-offerings"])
@pytest.mark.parametrize("mesh", [0, 2], ids=["no-mesh", "mesh-2"])
@pytest.mark.parametrize("delta_on", [False, True], ids=["delta-off", "delta-on"])
@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("rtt", RTTS)
def test_routing_sites_decide_as_the_reference(pins, rtt, force, delta_on, mesh, offerings):
    """Both routing sites, the same decisions on the same weighed cells
    (the sweep's on its plain pow2 dims, before any mesh alignment), the
    same host records under the same buckets, the same device dispatches
    and the same results."""
    from karpenter_tpu.ops import delta as jdelta
    from karpenter_tpu_torch.ops import delta as tdelta

    pins(rtt, force)
    try:
        for mod in (jdelta, tdelta):
            mod.configure(mode="on" if delta_on else "off")
        got = {pkg: _drive(pkg, offerings, mesh) for pkg in (JAX, PORT)}
    finally:
        for mod in (jdelta, tdelta):
            mod.configure(mode="off")
    (jd, jc, ja, jr, _), (td, tc, ta, tr, _) = got[JAX], got[PORT]
    assert td == jd
    if offerings and "catalog.row_compat" in jc:
        jc["catalog.row_compat"]["device"] //= 2
    assert tc == jc
    assert ta == ja == 0  # the reference's delta-warm exception never fires
    assert len(tr) == len(jr)
    for a, b in zip(tr, jr):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y)
    # the grid reaches both sides: the pins force one, the 100 us pin
    # splits the adaptive route
    sides = {out for _, _, out in td}
    if force is None and rtt == 1e-4:
        assert sides == {True, False}, td
    elif force is not None:
        assert sides == {force == "device"}, td


# -- 3. the resident matrices hold the host rows -----------------------------------------


@pytest.mark.parametrize("offerings", [True, False], ids=["offerings", "no-offerings"])
def test_host_row_batch_then_device_sweep_equals_the_plain_path(monkeypatch, offerings):
    """Row batches through the numpy twin, then a sweep on the device
    route: the resident device matrices hold the host rows (appended, no
    dispatch), and the sweep equals an engine pinned to the device."""
    kobs = _m(PORT, "observability.kernels")
    queries = build_queries(PORT, 1)
    outs = {}
    for mode in ("host", "device"):
        engine = _engine(PORT, offerings, 0)
        monkeypatch.setattr(tcat, "FORCE_BACKEND", mode)
        rows = [engine.rows_for(q) for q in queries]
        kobs.registry().reset()
        engine._ensure_rows()
        snap = kobs.registry().counts_snapshot()["catalog.row_compat"]["shapes"]
        phases = next(iter(snap.values()))
        assert (phases["host"], phases["warmup"]) == ((1, 0) if mode == "host" else (0, 1))
        np.testing.assert_array_equal(engine._req_compat_d.numpy(), engine._req_compat)
        np.testing.assert_array_equal(engine._offer_compat_d.numpy(), engine._offer_compat)
        monkeypatch.setattr(tcat, "FORCE_BACKEND", "device")
        f = engine.feasibility(rows, np.zeros((len(queries), len(engine.resource_dims))),
                               engine.key_presence(queries))
        outs[mode] = (engine._req_compat, engine._offer_compat, f.compat, f.has_offering)
    for a, b in zip(outs["host"], outs["device"]):
        np.testing.assert_array_equal(a, b)
    kobs.registry().reset()


# -- 4. the probe ----------------------------------------------------------------------


def test_probe_measures_once_per_device(monkeypatch):
    monkeypatch.setattr(tcat, "_RTT_CACHE", {})
    monkeypatch.setattr(tcat, "PINNED_RTT", None)
    rtt = tcat.device_rtt_s("cpu")
    assert 0 < rtt < 1.0 and tcat._RTT_CACHE == {torch.device("cpu"): rtt}
    assert tcat.device_rtt_s(torch.device("cpu")) == rtt
    monkeypatch.setattr(tcat, "PINNED_RTT", 5e-3)
    assert tcat.device_rtt_s("cpu") == 5e-3


def test_probe_fault_is_a_kernel_error_never_cached(monkeypatch):
    """A probe that raises fails the call as a KernelError; nothing is
    cached, so no later decision reads an infinite round trip (the
    reference's `inf`, which would send every batch to the host)."""
    monkeypatch.setattr(tcat, "_RTT_CACHE", {})
    monkeypatch.setattr(tcat, "PINNED_RTT", None)
    monkeypatch.setattr(tcat, "FORCE_BACKEND", None)

    def broken(self, *a, **kw):
        raise RuntimeError("device lost")

    engine = _engine(PORT, True, 0)
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "cpu", broken)
        with pytest.raises(KernelError, match="rtt probe: RuntimeError: device lost"):
            tcat._use_device(1e12, 1.0, "cpu")
        with pytest.raises(KernelError, match="rtt probe"):
            engine.warmup()
    assert tcat._RTT_CACHE == {}
    assert not getattr(engine, "_warmed", False)
    assert tcat.device_rtt_s("cpu") < float("inf")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a torch without CUDA")
def test_probe_on_a_cuda_device_without_a_card_fails():
    """A CUDA engine's probe where no card is: a KernelError, never the
    host route."""
    with pytest.raises(KernelError, match="rtt probe"):
        tcat.device_rtt_s(torch.device("cuda", 0))
    assert torch.device("cuda", 0) not in tcat._RTT_CACHE


def test_warm_start_probes_the_engine_device(monkeypatch):
    """aot.warm_start probes the engine's device before its walk, as the
    reference's probes its backend; a fault there fails the boot."""
    from karpenter_tpu_torch.aot import compiler
    from karpenter_tpu_torch.aot import ladder as ladder_mod

    seen = []
    monkeypatch.setattr(tcat, "device_rtt_s", lambda device: seen.append(device) or 1e-4)
    engine = _engine(PORT, True, 0)
    monkeypatch.setattr(compiler, "_cube_plans", lambda *a: [])
    monkeypatch.setattr(compiler, "_row_compat_plans", lambda *a: [])
    monkeypatch.setattr(compiler, "_solve_scan_plans", lambda *a: [])
    monkeypatch.setattr(compiler, "_solve_block_plans", lambda *a: [])
    try:
        compiler.warm_start(engine, ladder=ladder_mod.DEFAULT, cache=None)
    finally:
        tw.reset_aot(PORT)
    assert seen and seen[0] == engine.device

    def fault(device):
        raise KernelError("rtt probe: RuntimeError: device lost")

    monkeypatch.setattr(tcat, "device_rtt_s", fault)
    try:
        with pytest.raises(KernelError):
            compiler.warm_start(_engine(PORT, True, 0), ladder=ladder_mod.DEFAULT, cache=None)
    finally:
        tw.reset_aot(PORT)


# -- 5. the reference's own cases, on both packages --------------------------------------


@pytest.mark.parametrize("case", range(4))
def test_reference_backend_twins_on_both_packages(case):
    """tests/test_catalog_engine.py's host/device equality case: the
    engine pinned to the host twins, then to the device, equal bits."""
    tw.twin("test_catalog_engine", f"TestBackendTwins::test_host_device_identical[{case}]")


def test_reference_sim_kernel_report_on_both_packages():
    """tests/test_kernel_observatory.py's same-seed sim case: under the
    sim's pinned round trip both packages send the run's small batches to
    their host twins, so the reports, digests and host records agree."""
    ref, port = tw.twin("test_kernel_observatory",
                        "TestSimReportDeterminism::test_same_seed_identical_kernel_reports")
    assert ref and ref == port
