"""The port's topology-aware driver against the JAX package's.

The reference's randomized cases (tests/test_device_parity.py, copied in
tests/torch_topo_cases.py with the package as a parameter) are built in
each package's own API and solved three times:

- by the JAX package on its device path (CatalogEngine with
  FORCE_BACKEND="device", STRICT so a driver fault raises instead of
  falling back to the host loop);
- by the port's host loop (engine=None), the semantics oracle;
- by the port's device path on a device="cpu" engine (its plain torch
  versions), which must have run its topology driver, not the host loop.

All three must give exactly the same decisions: claims with their pool,
instance-type options, pods, requirements and minValues annotation, pods
on existing nodes, and pod errors.

The port keeps one rule the reference has only under STRICT: a decline
moves to the next attempt (and from the last one to the host loop), but
any other error aborts the attempt, restores the topology counts and
fails the solve. `test_topology_fault_*` hold that rule.
"""

from __future__ import annotations

import itertools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import catalog as jcatalog  # noqa: E402
from karpenter_tpu.ops import ffd as jffd  # noqa: E402
from karpenter_tpu.ops import fused as jfused  # noqa: E402
from karpenter_tpu.scheduler import nodeclaim as jnodeclaim  # noqa: E402
from karpenter_tpu_torch.device import KernelError  # noqa: E402
from karpenter_tpu_torch.mesh import Mesh  # noqa: E402
from karpenter_tpu_torch.ops import catalog as tcatalog  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import ffd as tffd  # noqa: E402
from karpenter_tpu_torch.ops import ffd_topo as tffd_topo  # noqa: E402
from karpenter_tpu_torch.ops import fused as tfused  # noqa: E402
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim  # noqa: E402
from test_torch_solve import DEVICE_FAULTS, _break_cube  # noqa: E402
from torch_topo_cases import (  # noqa: E402
    api,
    build_case,
    case_catalog,
    case_env,
    decisions,
    reset_counters,
)

torch.set_num_threads(1)

J, T = "karpenter_tpu", "karpenter_tpu_torch"
# a topology case whose solve meets new requirement rows after its first
# placements (9 row batches in all)
MID_SOLVE_SEED = 9


@pytest.fixture
def twin(monkeypatch):
    """The JAX package on its device programs under STRICT, both scans off,
    fresh hostname and placeholder counters; the port's attempts recorded:
    which driver class emitted the solve, and which declined a shape."""
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")
    monkeypatch.setattr(jffd, "STRICT", True)
    monkeypatch.setattr(jfused, "FUSED_MODE", "off")
    monkeypatch.setattr(tfused, "FUSED_MODE", "off")
    for mod in (jnodeclaim, tnodeclaim):
        monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
    for mod in (jffd, tffd):
        monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))
    log = []
    emit, run = tffd._DeviceSolve.emit, tffd._DeviceSolve.run

    def logged_emit(self):
        log.append(("served", type(self).__name__))
        return emit(self)

    def logged_run(self, timeout):
        try:
            return run(self, timeout)
        except tffd._IneligibleShape:
            log.append(("declined", type(self).__name__))
            raise

    monkeypatch.setattr(tffd._DeviceSolve, "emit", logged_emit)
    monkeypatch.setattr(tffd._DeviceSolve, "run", logged_run)
    return log


def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices()[:n]), ("pods",))


def twin_solve(log, seed, *, mesh_devices=0, pods=None, **flags):
    """The case solved by the JAX device path, the port's host loop and the
    port's device path: (want, host, got, port counter deltas)."""
    case_flags = {k: v for k, v in flags.items() if k != "strict"}
    if flags.get("strict"):
        case_flags["reserved"] = True
    cases = {pkg: build_case(pkg, seed, **case_flags) if pods is None else pods(pkg)
             for pkg in (J, T)}
    env_flags = {k: flags[k] for k in ("reserved", "strict", "best_effort") if k in flags}

    def leg(pkg, engine):
        reset_counters(pkg)
        env = case_env(pkg, cases[pkg], engine, **env_flags)
        return decisions(api(pkg), env.schedule(cases[pkg][4]()))

    def catalog(pkg):
        return case_catalog(pkg, flags.get("reserved", False), flags.get("strict", False))

    want = leg(J, jcatalog.CatalogEngine(
        catalog(J), mesh=_jax_mesh(mesh_devices) if mesh_devices else None))
    host = leg(T, None)
    del log[:]
    before = (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS, tfused.FUSED_SOLVES,
              dict(tfused.FUSED_DECLINES), tffd_topo._TOPO_SOLVES_CTR.value())
    mesh = Mesh([torch.device("cpu")] * mesh_devices) if mesh_devices else None
    got = leg(T, tcatalog.CatalogEngine(catalog(T), device="cpu", mesh=mesh))
    declines = {k: v - before[3].get(k, 0) for k, v in tfused.FUSED_DECLINES.items()
                if v != before[3].get(k, 0)}
    counts = {
        "device_solves": tffd.DEVICE_SOLVES - before[0],
        "device_fallbacks": tffd.DEVICE_FALLBACKS - before[1],
        "fused_solves": tfused.FUSED_SOLVES - before[2],
        "declines": declines,
        "topo_solves": tffd_topo._TOPO_SOLVES_CTR.value() - before[4],
        "attempts": list(log),
    }
    return want, host, got, counts


def _assert_topo_driver(want, host, got, counts):
    assert got == want, "decisions differ from the JAX package's"
    assert got == host, "decisions differ from the port's host loop"
    assert counts["device_solves"] == 1 and counts["device_fallbacks"] == 0, counts
    assert counts["topo_solves"] == 1, counts
    assert ("served", "_TopoSolve") in counts["attempts"], counts
    assert got[0] or got[1] or got[2], "an empty case"


@pytest.mark.parametrize("seed", range(12))
def test_topology_spread_matches_jax(twin, seed):
    """Spread over zone / hostname / capacity-type / arch / custom keys, pod
    (anti-)affinity, inverse anti-affinity from bound pods, host ports,
    volumes: the reference's `test_topology_spread_decision_parity`."""
    _assert_topo_driver(*twin_solve(twin, seed, topo=True))


@pytest.mark.parametrize("seed", [101, 147, 469])
def test_topology_regressions_match_jax(twin, seed):
    """The reference's soak regressions: a group representative mutated by a
    later relax rung (101, 147), a topology group created mid-solve by a
    relaxed multi-term node affinity (469)."""
    _assert_topo_driver(*twin_solve(twin, seed, topo=True))


@pytest.mark.parametrize("seed", range(6))
def test_reserved_with_topology_matches_jax(twin, seed):
    _assert_topo_driver(*twin_solve(twin, seed, topo=True, reserved=True))


@pytest.mark.parametrize("seed", range(6))
def test_strict_reserved_matches_jax(twin, seed):
    """Strict reserved mode routes every solve to the topology driver (its
    reservation errors abort pod scans)."""
    _assert_topo_driver(*twin_solve(twin, seed, strict=True))


@pytest.mark.parametrize("seed", range(6))
def test_best_effort_with_topology_matches_jax(twin, seed):
    _assert_topo_driver(*twin_solve(twin, seed, topo=True, best_effort=True))


@pytest.mark.parametrize("seed", range(4))
def test_mesh_with_topology_matches_jax(twin, seed):
    """The sweep sharded over an 8-shard mesh (the JAX package's 8 virtual
    CPU devices, the port's Mesh([cpu] * 8))."""
    _assert_topo_driver(*twin_solve(twin, seed, topo=True, mesh_devices=8))


@pytest.mark.parametrize("seed", range(4))
def test_fused_on_topology_declines_matches_jax(twin, monkeypatch, seed):
    """With the fused scan forced on in both packages, a topology solve is
    declined with reason `topo` and served by the topology driver."""
    monkeypatch.setattr(jfused, "FUSED_MODE", "on")
    monkeypatch.setattr(tfused, "FUSED_MODE", "on")
    want, host, got, counts = twin_solve(twin, seed, topo=True)
    _assert_topo_driver(want, host, got, counts)
    assert counts["fused_solves"] == 0
    assert counts["declines"] == {"topo": 1}, counts


def _prefer_no_schedule_pods(pkg):
    """A plain batch (no topology) with a second pool tainted
    PreferNoSchedule: the relax ladder's toleration rung routes the whole
    solve to the topology driver. The untainted pool offers amd64 only, so
    the arm64 pods land on the tainted one after relaxing."""
    a = api(pkg)
    amd64 = [{"key": a.wk.LABEL_ARCH, "operator": "In", "values": ["amd64"]}]
    pools = [
        a.nodepool("default", weight=5, requirements=amd64),
        a.nodepool("soft", weight=10, taints=[
            a.Taint(key="soft", value="lane", effect="PreferNoSchedule")]),
    ]
    cpus = ["250m", "500m", "1", "2", "4"]

    def build_pods():
        pods = []
        for i in range(96):
            p = a.unschedulable_pod(
                name=f"p-{i:05d}",
                requests={"cpu": cpus[i % 5], "memory": "1Gi"},
                node_selector={a.wk.LABEL_ARCH: "arm64"} if i % 3 == 0 else None,
            )
            p.metadata.uid = f"uid-{i:05d}"
            p.metadata.creation_timestamp = float(i % 7)
            pods.append(p)
        return pods

    return pools, [], [], [], build_pods


def test_prefer_no_schedule_matches_jax(twin):
    want, host, got, counts = twin_solve(twin, 0, pods=_prefer_no_schedule_pods)
    _assert_topo_driver(want, host, got, counts)
    assert counts["attempts"] == [("served", "_TopoSolve")], counts
    assert {c[0] for c in got[0]} == {"default", "soft"}


def _preferred_affinity_pods(pkg):
    """No topology and no tainted pool, but pods with preferred (and
    multi-term required) node affinity: the plain driver declines the shape
    and the topology driver's relax ladder serves it."""
    a = api(pkg)
    zones = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]

    def term(values):
        return a.NodeSelectorTerm(match_expressions=[
            {"key": a.wk.LABEL_TOPOLOGY_ZONE, "operator": "In", "values": values}])

    def build_pods():
        pods = []
        for i in range(96):
            kw = {}
            if i % 4 == 0:
                kw["affinity"] = a.Affinity(node_affinity=a.NodeAffinity(preferred=[
                    a.PreferredSchedulingTerm(weight=50, preference=term([zones[i % 3]]))]))
            elif i % 4 == 1:
                kw["affinity"] = a.Affinity(node_affinity=a.NodeAffinity(
                    required=[term(["kwok-zone-9"]), term(zones[:2])]))
            p = a.unschedulable_pod(name=f"p-{i:05d}",
                                    requests={"cpu": ["500m", "1", "2"][i % 3]}, **kw)
            p.metadata.uid = f"uid-{i:05d}"
            p.metadata.creation_timestamp = float(i % 7)
            pods.append(p)
        return pods

    return [a.nodepool("default")], [], [], [], build_pods


def test_relax_ladder_retry_matches_jax(twin):
    want, host, got, counts = twin_solve(twin, 0, pods=_preferred_affinity_pods)
    _assert_topo_driver(want, host, got, counts)
    assert counts["attempts"] == [("declined", "_DeviceSolve"), ("served", "_TopoSolve")]


def _counts_view(topology):
    """The topology's groups and their per-domain counts, for equality."""
    counts, groups, inverse, shapes = topology.snapshot_counts()
    return [(id(tg), d, e) for tg, d, e in counts], groups, inverse, shapes


def _fault_solve(monkeypatch, seed, break_fn, engine=None):
    """A port topology solve (a device="cpu" engine) whose device entry
    `break_fn(topology, before)` breaks after the scheduler is built:
    (raised, counts before, counts after, counter deltas)."""
    case = build_case(T, seed, topo=True)
    reset_counters(T)
    engine = engine or tcatalog.CatalogEngine(api(T).CATALOG, device="cpu")
    env = case_env(T, case, engine)
    pods = case[4]()
    built = {}
    orig = tffd.solve_device

    def spy(scheduler, pods_, timeout=60.0):
        built["before"] = _counts_view(scheduler.topology)
        built["topology"] = scheduler.topology
        break_fn(scheduler.topology, built["before"])
        return orig(scheduler, pods_, timeout)

    monkeypatch.setattr(tffd, "solve_device", spy)
    t0, f0 = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
    with pytest.raises(Exception) as info:
        env.schedule(pods)
    after = _counts_view(built["topology"])
    return info.value, built["before"], after, (tffd.DEVICE_SOLVES - t0,
                                               tffd.DEVICE_FALLBACKS - f0)


@pytest.mark.parametrize("fault", sorted(DEVICE_FAULTS))
def test_topology_fault_in_sweep_fails_the_solve(twin, monkeypatch, fault):
    """A fault in the topology driver's template sweep (the cube) fails the
    solve as a KernelError: no fallback, the counts as before the solve."""
    err, before, after, deltas = _fault_solve(
        monkeypatch, 0, lambda topology, before: _break_cube(monkeypatch, fault))
    assert isinstance(err, KernelError), err
    assert deltas == (0, 0)
    assert after == before


@pytest.mark.parametrize("fault", sorted(DEVICE_FAULTS))
def test_topology_fault_mid_solve_restores_counts(twin, monkeypatch, fault):
    """A fault in a row batch met mid-solve (a zone-narrowed joint's new
    requirement rows, after placements were recorded) aborts the attempt:
    the topology counts are restored to their pre-solve snapshot, the
    relaxed pods undone, and the solve fails as a KernelError. With delta
    solves on, the rollback leaves the engine's scan residency (seeded by a
    fused solve just before) invalidated, not stale."""
    from karpenter_tpu_torch.ops import delta as tdelta

    engine = tcatalog.CatalogEngine(api(T).CATALOG, device="cpu")
    mode, every = tdelta.DELTA_MODE, tdelta.RESOLVE_FULL_EVERY
    tdelta.configure(mode="on")
    tdelta.invalidate_all("test")
    try:
        monkeypatch.setattr(tfused, "FUSED_MODE", "on")
        seed_case = build_case(T, 0, fused=True)
        reset_counters(T)
        case_env(T, seed_case, engine).schedule(seed_case[4]())
        residency = tdelta.scan_residency(engine)
        assert residency.state is not None, "the fused solve seeded no residency"
        monkeypatch.setattr(tfused, "FUSED_MODE", "off")
        _check_mid_solve_fault(monkeypatch, fault, engine)
        assert residency.state is None, "the rollback left the scan residency stale"
    finally:
        tdelta.invalidate_all("test")
        tdelta.configure(mode=mode, resolve_full_every=every)


def _check_mid_solve_fault(monkeypatch, fault, engine):
    seen = {"changed": False}
    real = tfeas.req_rows_vs_targets

    def break_rows(topology, before):
        def flaky(*args, **kw):
            if _counts_view(topology) == before:
                return real(*args, **kw)
            seen["changed"] = True  # placements already recorded
            raise DEVICE_FAULTS[fault]()

        monkeypatch.setattr(tfeas, "req_rows_vs_targets", flaky)

    err, before, after, deltas = _fault_solve(monkeypatch, MID_SOLVE_SEED, break_rows, engine)
    assert seen["changed"], "no row batch after the first placement"
    assert isinstance(err, KernelError), err
    assert deltas == (0, 0)
    assert after == before


@pytest.mark.parametrize("seed,flags", [
    (0, {"topo": True}),
    (5, {"topo": True}),
    (2, {"topo": True, "reserved": True}),
    (1, {"strict": True}),
], ids=["topo-0", "topo-5", "reserved-topo-2", "strict-1"])
def test_case_copy_matches_reference_generator(twin, seed, flags):
    """tests/torch_topo_cases.py run on the JAX package gives exactly the
    host decisions of the reference's own generator and scheduler
    environment (tests/test_device_parity.py `run_case`)."""
    import test_device_parity

    want, dev, ran = test_device_parity.run_case(seed, **flags)
    assert want == dev and ran
    case_flags = {k: v for k, v in flags.items() if k != "strict"}
    if flags.get("strict"):
        case_flags["reserved"] = True
    case = build_case(J, seed, **case_flags)
    reset_counters(J)
    env_flags = {k: v for k, v in flags.items() if k in ("reserved", "strict")}
    got = decisions(api(J), case_env(J, case, None, **env_flags).schedule(case[4]()))
    assert got == want
