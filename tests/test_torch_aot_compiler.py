"""The port's AOT compile service (aot/compiler.py) against the JAX package's.

Every case of the reference's tests/test_aot.py, and the two warm-start
cases of tests/test_perf_floor.py, runs on both packages with its own
assertions (tests/torch_twins.py: the port's engines on the CPU, a jax-only
line as `PORT_LINES` gives it). Each warm start's buckets are recorded —
kernel, bucket, scope, and whether each was already loaded, a cache hit or
a fresh compile — and the two packages' records must be equal.

Beside them, the ladder's padding at each of its dispatch sites (the
catalog's row batch, the sweep, the fused scan, the group solve, the delta
pass's group axis): decisions with a ladder attached equal those without
one, on the same numpy-seeded inputs, through the JAX package and the
port. And the port's own parts: the executable's signature check, a
KernelError from an installed executable or from a warm launch failing the
solve, the boot and the binary, a corrupt entry evicted and rebuilt, and a
CPU engine's cache entries missing for another device.
"""

from __future__ import annotations

import itertools
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

J, T = tw.J, tw.T

PERF_FLOOR_CASES = [
    "TestPerfFloor::test_warm_boot_zero_fresh_ladder_compiles",
    "TestPerfFloor::test_cost_tables_built_exactly_once_at_warm_start",
]


@pytest.fixture(autouse=True)
def no_aot_state_left():
    """Each case starts and ends with no AOT state in either package."""
    for pkg in (J, T):
        tw.reset_aot(pkg)
    yield
    for pkg in (J, T):
        tw.reset_aot(pkg)


def _aot_records(obs) -> list:
    return [o for o in obs if o[0] == "aot-bucket"]


@pytest.mark.parametrize("case", tw.cases("test_aot"))
def test_aot_case_on_both_packages(case):
    tw.twin("test_aot", case)


@pytest.mark.parametrize("case", PERF_FLOOR_CASES)
def test_perf_floor_case_on_both_packages(case):
    ref, port = tw.twin("test_perf_floor", case)
    # both boots of each walk their buckets, the second from the cache
    assert _aot_records(port) and _aot_records(port) == _aot_records(ref)


def test_cold_then_warm_records_equal():
    """The walk's records of the reference's cold-then-warm case: every
    bucket fresh, then every bucket a hit, in both packages."""
    ref, port = tw.twin("test_aot", "TestWarmStart::test_cold_then_warm_boot_zero_fresh_compiles")
    records = _aot_records(port)
    assert records == _aot_records(ref)
    outcomes = [r[-1] for r in records]
    half = len(outcomes) // 2
    assert outcomes[:half] == [["fresh_compiles"]] * half
    assert outcomes[half:] == [["cache_hits"]] * half


# -- decisions with a ladder equal those without one, at each padding site --------


def _m(pkg: str, name: str):
    return tw._m(pkg, name)


@pytest.fixture
def device_programs(monkeypatch):
    """The JAX package on its device programs (FORCE_BACKEND="device", the
    fused scan in real float64), both packages' off-ladder state reset."""
    from test_torch_delta import _x64

    monkeypatch.setattr(_m(J, "ops.catalog"), "FORCE_BACKEND", "device")
    monkeypatch.setattr(_m(T, "ops.catalog"), "FORCE_BACKEND", "device")
    monkeypatch.setattr(_m(J, "ops.packer"), "scan_x64", _x64)
    for pkg in (J, T):
        _m(pkg, "aot.runtime").reset_off_ladder()
    yield
    for pkg in (J, T):
        _m(pkg, "aot.runtime").reset_off_ladder()


def _with_and_without(pkg: str, ladder_spec: dict, run) -> tuple:
    """run(pkg, ladder) with no ladder, then with the ladder attached to
    the engine; also the off-ladder dispatches of the ladder's kernels that
    the ladder's run added."""
    lad = _m(pkg, "aot.ladder").make(ladder_spec)
    ctr = _m(pkg, "metrics").global_registry.get("karpenter_aot_offladder_dispatches_total")

    def off():
        return sum(ctr.value({"kernel": k, "mesh": ""}) for k in ladder_spec)

    plain = run(pkg, None)
    base = off()
    laddered = run(pkg, lad)
    return plain, laddered, off() - base


def _all_equal(ladder_spec: dict, run, compare=None):
    """The run on both packages, with and without the ladder: four equal
    results, no dispatch of a laddered kernel off the ladder."""
    seen = {pkg: _with_and_without(pkg, ladder_spec, run) for pkg in (J, T)}
    cmp = compare or (lambda a, b: a == b)
    for pkg in (J, T):
        plain, laddered, off = seen[pkg]
        assert cmp(laddered, plain), pkg
        assert off == 0, (pkg, off)
    assert cmp(seen[T][0], seen[J][0])
    return seen


def _arrays_equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(a, b))


def _engine(pkg: str, ladder):
    from test_torch_group import engine_for

    engine = engine_for(pkg)
    engine.aot_ladder = ladder
    return engine


def _zone_rows(pkg: str, engine, n: int) -> list:
    rq = _m(pkg, "scheduling.requirements")
    wk = _m(pkg, "apis.labels")
    rng = np.random.RandomState(5)
    out = []
    for i in range(n):
        reqs = rq.Requirements(
            rq.Requirement(wk.LABEL_TOPOLOGY_ZONE, rq.Operator.IN,
                           [f"kwok-zone-{int(z)}" for z in rng.choice(4, size=1 + i % 3, replace=False) + 1]),
            rq.Requirement(wk.LABEL_ARCH, rq.Operator.IN, [["amd64", "arm64"][i % 2]]),
            rq.Requirement("karpenter.sh/capacity-type", rq.Operator.IN, [["spot", "on-demand"][i % 3 == 0]]),
        )
        if i % 5 == 0:
            reqs.add(rq.Requirement(wk.LABEL_OS, rq.Operator.NOT_IN, ["windows"]))
        if i % 2:
            reqs.add(rq.Requirement(wk.LABEL_HOSTNAME, rq.Operator.NOT_IN, [f"node-{i}"]))
        out.append(engine.rows_for(reqs))
    return out


def test_row_batch_ladder_padding_keeps_the_rows(device_programs):
    """catalog.row_compat: a 40-row batch padded to the 64 rung (its padding
    rows edge-replicated and sliced off) computes the rows the unpadded
    batch does."""

    def run(pkg, ladder):
        engine = _engine(pkg, ladder)
        _zone_rows(pkg, engine, 40)
        engine._ensure_rows()
        return engine._req_compat.copy(), engine._offer_compat.copy(), engine._row_trivial.copy()

    seen = _all_equal({"catalog.row_compat": [(64,)]}, run, _arrays_equal)
    assert seen[T][0][0].shape[0] > 32


def test_sweep_ladder_padding_keeps_the_feasibility(device_programs):
    """feasibility.cube: a sweep padded to a (24, 24) rung — not a power of
    two on either axis — gives the feasibility of its pow2 padding."""

    def run(pkg, ladder):
        engine = _engine(pkg, ladder)
        row_sets = _zone_rows(pkg, engine, 17)
        rng = np.random.RandomState(3)
        requests = np.zeros((len(row_sets), len(engine.resource_dims)))
        requests[:, 0] = rng.choice([0.5, 2.0, 8.0], size=len(row_sets))
        kp = np.zeros((len(row_sets), engine._key_capacity), dtype=bool)
        f = engine.feasibility(row_sets, requests, kp)
        return f.compat, f.fits, f.has_offering

    seen = _all_equal({"feasibility.cube": [(24, 24)]}, run, _arrays_equal)
    assert seen[T][0][0].shape[0] == 17


def _grouped(pkg: str, engine, seed: int, pods: int, n_shapes: int = 10):
    from test_torch_group import build_shapes, churn_batch

    rng = np.random.RandomState(seed)
    reqs, requests = churn_batch(pkg, engine, rng, build_shapes(pkg, n_shapes), pods)
    return _m(pkg, "ops.packer").encode_pods_for_packer(engine, reqs, requests)


def test_group_solve_ladder_padding_keeps_the_solve(device_programs):
    """packer.solve_block: the group axis padded to a 96 rung (counts 0 in
    the padding rows; 96 is not a power of two) solves as the unpadded
    axis does."""

    def run(pkg, ladder):
        engine = _engine(pkg, ladder)
        solver = _m(pkg, "ops.packer").GroupSolver(engine)
        return [tuple(np.asarray(a) for a in solver.solve(_grouped(pkg, engine, s, 80)))
                for s in (1, 2)]

    def same(a, b):
        return all(_arrays_equal(x, y) for x, y in zip(a, b))

    _all_equal({"packer.solve_block": [(96,)]}, run, same)


def test_delta_group_axis_takes_the_ladder_rung(device_programs):
    """ops/delta._bucket_groups: with delta solves on, the group residency
    pads its axis and its frontier to the solve_block rung (24), and each
    pass equals the unpadded solve."""
    saved = []
    for pkg in (J, T):
        d = _m(pkg, "ops.delta")
        saved.append((d, d.DELTA_MODE, d.RESOLVE_FULL_EVERY))
        d.configure(mode="on", resolve_full_every=4)
        d.invalidate_all("test-setup")
    try:
        def run(pkg, ladder):
            engine = _engine(pkg, ladder)
            d = _m(pkg, "ops.delta")
            if ladder is not None:
                assert d._bucket_groups(engine, 9) == 24
            solver = _m(pkg, "ops.packer").GroupSolver(engine)
            out = []
            for p in range(4):
                g = _grouped(pkg, engine, 30 + p, 40 + 20 * p, 8 + p % 3)
                out.append(tuple(np.asarray(a) for a in solver.solve(g)))
            out.append(d.group_residency(solver).warm_passes)
            d.invalidate_all("test-leg")
            return out

        def same(a, b):
            return a[-1] == b[-1] and all(_arrays_equal(x, y) for x, y in zip(a[:-1], b[:-1]))

        seen = _all_equal({"packer.solve_block": [(24,)]}, run, same)
        assert seen[T][1][-1] > 0  # warm passes ran on the padded axis
    finally:
        for d, mode, every in saved:
            d.configure(mode=mode, resolve_full_every=every)
            d.invalidate_all("test-teardown")


def test_scan_ladder_rung_keeps_the_decisions(device_programs, monkeypatch):
    """packer.solve_scan: a fused solve padded to a (2048, 64, 1024, 8, 128,
    1, 8) rung — pods, groups, claims and families from the rung (the claim
    axis not from the estimate); the batch has no nodes and no limits —
    decides as the pow2-padded scan does, in both packages."""
    import test_torch_solve as tsolve

    for pkg in (J, T):
        monkeypatch.setattr(_m(pkg, "ops.fused"), "FUSED_MODE", "on")
        for name, attr in (("scheduler.nodeclaim", "_hostname_counter"), ("ops.ffd", "_placeholder_counter")):
            monkeypatch.setattr(_m(pkg, name), attr, itertools.count(1))
    s = tsolve.spec(4)

    def run(pkg, ladder):
        fused = _m(pkg, "ops.fused")
        before = fused.FUSED_SOLVES
        scheduler, pods = tsolve.build_solve(pkg, s)
        scheduler.engine.aot_ladder = ladder
        for name, attr in (("scheduler.nodeclaim", "_hostname_counter"), ("ops.ffd", "_placeholder_counter")):
            setattr(_m(pkg, name), attr, itertools.count(1))
        out = tsolve.decisions(scheduler.solve(pods))
        assert fused.FUSED_SOLVES == before + 1, pkg
        return out

    seen = _all_equal({"packer.solve_scan": [(2048, 64, 1024, 8, 128, 1, 8)]}, run)
    assert seen[T][0][0], "no claims"
