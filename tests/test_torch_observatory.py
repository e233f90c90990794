"""The port's kernel observatory (observability/kernels.py, tracing/kernel.py)
against the JAX package's, on the CPU.

1. The reference's tests/test_kernel_observatory.py cases that need no
   solver daemon, operator or simulator, on both packages, the registry
   snapshots compared. A "kernel" is a jitted function in the reference and
   a torch function in the port; the port's one compile is a kernel library
   built or loaded (device.build_count), made here by device.build_kernels()
   against stand-in sources (`fake_build`), so a first call per shape
   compiles in both packages.
2. Per-kernel named dispatch counts of whole solves — the fused scan, the
   native walk, delta churn, the group solver (full and delta), the
   topology driver, and their mesh twins — in each package's batch scope,
   the reference on its device programs (FORCE_BACKEND="device", the scan
   in real float64). The port's counts must equal the reference's but for
   DESIGNED_DIFFERENCES, applied by `as_port_counts`.
3. The steady-batch floor on both packages: the reference's own floor test
   (tests/test_perf_floor.py) run with `scan_x64` patched, and the port's
   counterpart, whose warm scan solve also dispatches its sweep.
4. The scan's 27-operand shape signature: equal in both packages for the
   same solve, and parsed by the ladder into the same rung.
5. The port's fence: CUDA outputs only, an event on each device's current
   stream, never without a measure() context or a compile, and a fault at
   the fence a KernelError that fails the solve (a stand-in CUDA output:
   there is no card here).
"""

from __future__ import annotations

import itertools
import os
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import catalog as jcatalog  # noqa: E402
from karpenter_tpu.ops import delta as jdelta  # noqa: E402
from karpenter_tpu.ops import ffd as jffd  # noqa: E402
from karpenter_tpu.ops import fused as jfused  # noqa: E402
from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu.scheduler import nodeclaim as jnodeclaim  # noqa: E402
from karpenter_tpu_torch import device as tdevice  # noqa: E402
from karpenter_tpu_torch.device import KernelError  # noqa: E402
from karpenter_tpu_torch.ops import delta as tdelta  # noqa: E402
from karpenter_tpu_torch.ops import ffd as tffd  # noqa: E402
from karpenter_tpu_torch.ops import fused as tfused  # noqa: E402
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim  # noqa: E402
from karpenter_tpu_torch.tracing import kernel as tktime  # noqa: E402
from test_torch_delta import JAX, PORT, PkgEnv, _m, _x64, plain_pods  # noqa: E402
from test_torch_group import build_shapes, churn_batch  # noqa: E402
from test_torch_mesh import STREAM, engine as mesh_engine, mesh_env  # noqa: E402
import test_perf_floor as jfloor  # noqa: E402
import test_torch_solve as tsolve  # noqa: E402

torch.set_num_threads(1)

PKGS = [JAX, PORT]
MIXED = ("250m", "500m", "1", "2")

# the named dispatches a solve makes differently in the port, each with its
# reason; as_port_counts applies them to the reference's counts
DESIGNED_DIFFERENCES = {
    "catalog.row_compat": (
        "a row batch is 2 dispatches in the reference, its row kernel called "
        "for the types and for the offerings (ops/catalog.py:410, 424), and "
        "1 in the port: one kt_row_compat launch against both (PR 8)"
    ),
    "packer.delta_pass": (
        "a delta group pass with a frontier is packer.solve_block_core + "
        "packer.delta_scatter + packer.delta_finalize in the reference "
        "(ops/delta.py:551-581) and one packer.delta_pass launch in the port "
        "(PR 9); a pass without a frontier is packer.delta_finalize in both"
    ),
    "uid_project": (
        "B6 (famu_ok) has no named dispatch in the reference "
        "(ops/fused.py:434-436) and none in the port"
    ),
    "steady scan batch": (
        "the reference's warm fused solve is {packer.solve_scan: 1} because "
        "its adaptive routing (_use_device, ops/catalog.py:59-117) sends the "
        "small warm sweep to its host twin (a record_host); the port has no "
        "host-twin route (ROADMAP Queue C item 2) and dispatches the sweep "
        "as feasibility.cube; with FORCE_BACKEND='device' the reference "
        "dispatches it too"
    ),
}


def as_port_counts(ref: dict) -> dict:
    """The reference's per-kernel dispatch counts of a batch as the port
    makes them (DESIGNED_DIFFERENCES)."""
    out = dict(ref)
    if "catalog.row_compat" in out:
        assert out["catalog.row_compat"] % 2 == 0, ref
        out["catalog.row_compat"] //= 2
    core = out.pop("packer.solve_block_core", 0)
    assert out.pop("packer.delta_scatter", 0) == core, ref
    if core:
        out["packer.delta_pass"] = core
        out["packer.delta_finalize"] -= core
        if not out["packer.delta_finalize"]:
            del out["packer.delta_finalize"]
    return out


def kobs(pkg):
    return _m(pkg, "observability.kernels")


def ktime(pkg):
    return _m(pkg, "tracing.kernel")


@pytest.fixture
def registries():
    """Both packages' process-global registries, reset before and after."""
    regs = {pkg: kobs(pkg).registry() for pkg in PKGS}
    for reg in regs.values():
        reg.reset()
    yield regs
    for reg in regs.values():
        reg.reset()


@pytest.fixture
def fake_build(monkeypatch, tmp_path):
    """device.build_kernels() on stand-in sources: `build(name)` adds a
    source and runs the real build, which loads it (its library path
    exists, ctypes.CDLL is stubbed in device.py) and grows the build
    counter once per new name."""
    sources: dict = {}
    lib = tmp_path / "libstandin.so"
    lib.write_bytes(b"")
    monkeypatch.setattr(tdevice, "_sources", lambda: dict(sources))
    monkeypatch.setattr(tdevice, "_so_path", lambda name, src: str(lib))
    monkeypatch.setattr(tdevice, "ctypes", types.SimpleNamespace(CDLL=lambda path: object()))
    monkeypatch.setattr(tdevice, "_libs", {})

    def build(name: str) -> None:
        sources.setdefault(name, f"csrc/{name}.cu")
        tdevice.build_kernels()

    return build


def make_kernel(pkg, fake_build, op=lambda x: x * 2.0):
    """(a kernel, its argument maker): a jitted function in the reference;
    in the port a torch function whose first call of a shape builds a
    library of its own (its compile)."""
    if pkg == JAX:
        return jax.jit(op), (lambda n: jnp.ones((n,)))
    name = f"k{id(op)}"

    def kernel(x):
        fake_build(f"{name}_{x.shape[0]}")
        return op(x)

    return kernel, (lambda n: torch.ones((n,)))


def walls_dropped(snap):
    """A registry snapshot without its wall-clock fields."""
    if isinstance(snap, dict):
        return {k: walls_dropped(v) for k, v in snap.items()
                if not k.endswith(("_s", "_wall_s")) and k not in ("aot",)}
    if isinstance(snap, list):
        return [walls_dropped(v) for v in snap]
    return snap


# -- 1. the reference's observatory cases, on both packages -------------------------


def test_dispatch_records_shapes_phases_and_cache_hits(registries, fake_build):
    seen = {}
    for pkg in PKGS:
        f, arg = make_kernel(pkg, fake_build)
        ktime(pkg).dispatch(f, arg(4), kernel="spec.k")  # cold: compiles
        ktime(pkg).dispatch(f, arg(4), kernel="spec.k")  # warm
        snap = registries[pkg].debug_snapshot("spec.k")
        assert snap["dispatches"] == 2 and snap["compiles"] == 1 and snap["cache_hits"] == 1
        assert snap["phases"] == {"warmup": 2, "steady": 0, "aot-warm": 0}
        assert [s["shape"] for s in snap["shapes"]] == ["4"]
        seen[pkg] = walls_dropped(snap)
    assert seen[PORT] == seen[JAX]


@pytest.mark.parametrize("pkg", PKGS)
def test_record_host_counts_host_twins(registries, pkg):
    reg = registries[pkg]
    reg.record_host("spec.twin", "8x8")
    reg.record_host("spec.twin", "8x8")
    snap = reg.debug_snapshot("spec.twin")
    assert snap["host_dispatches"] == 2 and snap["dispatches"] == 0
    assert snap["shapes"][0]["phases"]["host"] == 2


def test_shape_signature_covers_array_args_only():
    want = _m(JAX, "observability.kernels").shape_signature(
        (jnp.ones((4, 2)), "static", 7, jnp.ones((3,))))
    got = kobs(PORT).shape_signature((torch.ones((4, 2)), "static", 7, torch.ones((3,))))
    assert got == want == "4x2,3"
    # 0-d operands (the scan's n_pods, n_nodes) are one "1" segment in both
    assert kobs(PORT).shape_signature((torch.tensor(5, dtype=torch.int32),)) == \
        _m(JAX, "observability.kernels").shape_signature((np.int32(5),)) == "1"
    assert kobs(PORT).shape_signature(()) == "scalar"


@pytest.mark.parametrize("pkg", PKGS)
def test_debug_snapshot_unknown_kernel_is_none(registries, pkg):
    assert registries[pkg].debug_snapshot("nope") is None


def test_full_snapshot_table_and_phase(registries):
    seen = {}
    for pkg in PKGS:
        registries[pkg].record_host("spec.a", "1")
        snap = registries[pkg].debug_snapshot()
        assert snap["sealed"] is False and snap["phase"] == "warmup"
        assert any(row["kernel"] == "spec.a" for row in snap["kernels"])
        seen[pkg] = walls_dropped({k: v for k, v in snap.items() if k != "device_memory"})
    assert seen[PORT] == seen[JAX]


def test_warm_steady_dispatches_do_not_trip(registries, fake_build):
    seen = {}
    for pkg in PKGS:
        reg = registries[pkg]
        f, arg = make_kernel(pkg, fake_build, lambda x: x + 1.0)
        ktime(pkg).dispatch(f, arg(16), kernel="spec.seal")  # warmup compile
        reg.seal()
        assert reg.phase == "steady"
        for _ in range(3):
            ktime(pkg).dispatch(f, arg(16), kernel="spec.seal")
        assert reg.steady_recompiles() == 0
        seen[pkg] = reg.debug_snapshot("spec.seal")["phases"]
    assert seen[PORT] == seen[JAX] == {"warmup": 1, "steady": 3, "aot-warm": 0}


def test_forced_recompile_trips_guard(registries, fake_build):
    """A compile after the seal is a recompile in both packages: in the
    port, a kernel library built or loaded after the seal."""
    seen = {}
    for pkg in PKGS:
        reg = registries[pkg]
        f, arg = make_kernel(pkg, fake_build, lambda x: x + 1.0)
        ktime(pkg).dispatch(f, arg(16), kernel="spec.trip")
        reg.seal()
        fired = []
        reg.on_recompile(lambda k, s: fired.append((k, s)), key="spec")
        ctr = _m(pkg, "metrics").global_registry.get("karpenter_kernel_recompiles_total")
        base = ctr.value({"kernel": "spec.trip"})
        ktime(pkg).dispatch(f, arg(17), kernel="spec.trip")  # a shape never seen
        assert reg.steady_recompiles() == 1
        assert fired == [("spec.trip", "17")]
        assert ctr.value({"kernel": "spec.trip"}) == base + 1
        seen[pkg] = reg.debug_snapshot()["recompile_events"]
    assert seen[PORT] == seen[JAX] == [{"kernel": "spec.trip", "shape": "17"}]


def test_callback_replacement_by_key(registries, fake_build):
    for pkg in PKGS:
        reg = registries[pkg]
        a, b = [], []
        reg.on_recompile(lambda k, s: a.append(k), key="slot")
        reg.on_recompile(lambda k, s: b.append(k), key="slot")
        reg.seal()
        f, arg = make_kernel(pkg, fake_build, lambda x: x - 1.0)
        ktime(pkg).dispatch(f, arg(19), kernel="spec.slot")
        assert a == [] and b == ["spec.slot"], pkg


def test_repeat_sweeps_zero_recompiles(registries, monkeypatch):
    """A real engine's steady feasibility sweeps never recompile: in the
    port nothing builds once the kernels are loaded (on the CPU nothing
    builds at all)."""
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    for pkg in PKGS:
        catalog = _m(pkg, "cloudprovider.kwok.instance_types").construct_instance_types()
        kw = {"device": "cpu"} if pkg == PORT else {}
        engine = _m(pkg, "ops.catalog").CatalogEngine(catalog, **kw).warmup()
        rq, wk = _m(pkg, "scheduling.requirements"), _m(pkg, "apis.labels")
        rows = engine.rows_for(rq.Requirements(rq.Requirement(wk.LABEL_ARCH, rq.Operator.IN, ["amd64"])))
        req_vec = np.zeros((1, len(engine.resource_dims)))
        engine.feasibility([rows], req_vec)
        registries[pkg].seal()
        for _ in range(3):
            engine.feasibility([rows], req_vec)
        assert registries[pkg].steady_recompiles() == 0
        assert registries[pkg].debug_snapshot("feasibility.cube")["phases"]["steady"] == 3


@pytest.mark.parametrize("pkg", PKGS)
def test_outer_subtracts_inner_elapsed(registries, pkg):
    """Nested dispatches attribute wall time to the innermost only."""
    kt = ktime(pkg)

    def inner():
        time.sleep(0.05)
        return 1

    def outer():
        kt.dispatch(inner, kernel="spec.inner")
        time.sleep(0.02)
        return 2

    with kt.measure() as acc:
        kt.dispatch(outer, kernel="spec.outer")
    assert acc["dispatches"] == 2
    assert 0.06 < acc["execute_s"] < 0.11, acc
    reg = registries[pkg]
    assert 0.04 < reg.debug_snapshot("spec.inner")["execute_wall_s"] < 0.09
    assert reg.debug_snapshot("spec.outer")["execute_wall_s"] < 0.05


def test_unnamed_dispatch_accounting(registries, fake_build):
    seen = {}
    for pkg in PKGS:
        f, arg = make_kernel(pkg, fake_build, lambda x: x * 3.0)
        with ktime(pkg).measure() as acc:
            ktime(pkg).dispatch(f, arg(4))
            ktime(pkg).dispatch(f, arg(4))
        seen[pkg] = (acc["dispatches"], acc["compiles"])
        assert registries[pkg].debug_snapshot()["kernels"] == []  # unnamed: no record
    assert seen[PORT] == seen[JAX] == (2, 1)


def test_sample_device_memory_without_cuda_is_an_empty_shell(registries):
    """On the CPU nothing initialized CUDA: the sample is the empty shell,
    cached for /debug/kernels, and telemetry initializes nothing."""
    sample = kobs(PORT).sample_device_memory()
    assert sample == {"live_array_bytes": 0, "live_arrays": 0, "devices": []}
    assert registries[PORT].debug_snapshot()["device_memory"] == sample
    assert not torch.cuda.is_initialized()


def test_sample_device_memory_reads_the_caching_allocator(registries, monkeypatch):
    """With CUDA initialized (stand-in: two cards, one never used) the
    sample maps the allocator's stats: memory_allocated per card summed,
    active blocks, allocated bytes current/peak and the card's total."""
    from karpenter_tpu_torch.metrics import global_registry

    stats = {
        0: {"reserved_bytes.all.peak": 4096, "active.all.current": 3,
            "allocated_bytes.all.current": 1536, "allocated_bytes.all.peak": 2048},
        1: {},
    }
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats[d.index])
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 1536 if d.index == 0 else 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (10, 80 * 2**30))
    sample = kobs(PORT).sample_device_memory()
    assert sample == {
        "live_array_bytes": 1536, "live_arrays": 3,
        "devices": [{"device": "cuda:0", "bytes_in_use": 1536, "peak_bytes_in_use": 2048,
                     "bytes_limit": 80 * 2**30}],
    }
    assert global_registry.get("karpenter_device_live_array_bytes").value() == 1536.0
    assert global_registry.get("karpenter_device_memory_bytes").value(
        {"device": "cuda:0", "stat": "peak_bytes_in_use"}) == 2048.0


# -- 2. per-kernel dispatch counts of whole solves, against the reference ----------


@pytest.fixture
def twin(monkeypatch, registries):
    """Both packages on their device paths: the reference's programs pinned
    (FORCE_BACKEND="device", STRICT), its scan in real float64; fresh name
    counters, delta off with every residency dropped before and after.
    Yields the registries."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr(jffd, "STRICT", True)
    for mod in (jnodeclaim, tnodeclaim):
        monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
    for mod in (jffd, tffd):
        monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))
    saved = [(mod, mod.DELTA_MODE, mod.RESOLVE_FULL_EVERY) for mod in (jdelta, tdelta)]
    for mod in (jdelta, tdelta):
        mod.configure(mode="off", resolve_full_every=2)
        mod.invalidate_all("test-setup")
    yield registries
    for mod, mode, every in saved:
        mod.configure(mode=mode, resolve_full_every=every)
        mod.invalidate_all("test-teardown")


def _fused(monkeypatch, on: bool) -> None:
    for mod in (jfused, tfused):
        monkeypatch.setattr(mod, "FUSED_MODE", "on" if on else "off")


def _delta(on: bool) -> None:
    for mod in (jdelta, tdelta):
        mod.configure(mode="on" if on else "off")


def batches(pkg, regs, steps) -> list:
    """Each step of `steps` (callables of the package) in its own batch
    scope: [(dispatch counts by kernel, host records)]."""
    out = []
    for k, step in enumerate(steps):
        with regs[pkg].batch_scope(f"step {k}") as acc:
            step()
        out.append((dict(acc["kernels"]), acc["host_records"]))
    return out


def scan_steps(pkg, n=None):
    env = mesh_env(pkg, n)
    return [lambda: env.schedule(plain_pods(pkg, 96, cpus=MIXED))] * 2


def churn_steps(pkg, n=None):
    env = mesh_env(pkg, n)
    return [lambda make=make: env.schedule(make(pkg)) for make in STREAM]


def spread_pods(pkg: str, n: int = 120) -> list:
    """tests/test_torch_solve.py's zone-spread workload (two deployments,
    maxSkew 1 on the zone), in either package."""
    core, res = _m(pkg, "apis.core"), _m(pkg, "utils.resources")
    pods = []
    for i in range(n):
        pod = core.Pod(
            metadata=core.ObjectMeta(name=f"tp-{i:04d}", uid=f"tp-{i:04d}",
                                     labels={"app": f"a{i % 2}"}),
            spec=core.PodSpec(
                containers=[core.Container(requests=res.parse_resource_list({"cpu": "1"}))],
                topology_spread_constraints=[core.TopologySpreadConstraint(
                    max_skew=1, topology_key="topology.kubernetes.io/zone",
                    when_unsatisfiable="DoNotSchedule",
                    label_selector=core.LabelSelector(match_labels={"app": f"a{i % 2}"}),
                )],
            ),
        )
        pod.metadata.creation_timestamp = 0.0
        pod.status.conditions.append(core.Condition(type="PodScheduled", status="False",
                                                    reason="Unschedulable"))
        pods.append(pod)
    return pods


def topology_steps(pkg, n=None):
    env = mesh_env(pkg, n)
    return [lambda: env.schedule(spread_pods(pkg))] * 2


def group_steps(pkg, n=None):
    """A full solve (delta off), then with delta on a cold pass, passes
    with new shapes and a repeated pass (count-only: no frontier); on a
    mesh the sharded solve."""
    catalog = _m(pkg, "cloudprovider.kwok.instance_types").construct_instance_types()
    engine = mesh_engine(pkg, catalog, n)
    packer = _m(pkg, "ops.packer")
    solver = packer.GroupSolver(engine)
    rng = np.random.RandomState(21)
    passes = [churn_batch(pkg, engine, rng, build_shapes(pkg, 8 + (p % 3)), 60 + 20 * p)
              for p in range(5)]

    def run(p, delta_on):
        _delta(delta_on)
        solver.solve(packer.encode_pods_for_packer(engine, *passes[p]))

    return [lambda: run(0, False)] + [lambda p=p: run(p, True) for p in (0, 1, 1, 2, 3)]


SCENARIOS = {
    "scan": (True, False, scan_steps),
    "walk": (False, False, scan_steps),
    "churn": (True, True, churn_steps),
    "topology": (True, False, topology_steps),
    "group": (False, False, group_steps),
}


@pytest.mark.parametrize("n", [None, 2])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_solve_dispatch_counts_match_the_reference(twin, monkeypatch, scenario, n):
    """Per batch, the port's named dispatches by kernel are the
    reference's under DESIGNED_DIFFERENCES, and the host records (the
    topology count resyncs) are the same; on a 2-device mesh (the
    reference's virtual CPU devices, the port's CPU repeated) too."""
    fused_on, delta_on, steps = SCENARIOS[scenario]
    _fused(monkeypatch, fused_on)
    seen = {}
    for pkg in PKGS:
        _delta(delta_on)
        seen[pkg] = batches(pkg, twin, steps(pkg, n))
    assert [c for c, _ in seen[PORT]] == [as_port_counts(c) for c, _ in seen[JAX]], seen
    assert [h for _, h in seen[PORT]] == [h for _, h in seen[JAX]], seen
    assert any(c for c, _ in seen[PORT]), "no dispatch at all"
    names = {k for c, _ in seen[PORT] for k in c}
    want = {
        "scan": {"packer.solve_scan"}, "walk": {"feasibility.cube"},
        "churn": {"packer.solve_scan_full", "packer.solve_scan_resume"},
        "topology": {"feasibility.cube"},
        "group": {"packer.solve_block", "packer.delta_pass", "packer.delta_finalize"},
    }[scenario]
    if n:
        want = {{"feasibility.cube": "feasibility.cube_sharded",
                 "packer.solve_block": "packer.solve_block_sharded"}.get(k, k) for k in want}
        if scenario == "group":  # a mesh bypasses the group residency
            want = {"packer.solve_block_sharded"}
    assert want <= names, (want, names)


def test_designed_differences_are_exercised(twin, monkeypatch):
    """Each listed difference shows on the solves above: the reference's
    two row dispatches a batch, its three-dispatch delta pass, and no
    uid_project dispatch in either package."""
    _fused(monkeypatch, True)
    jax_counts = batches(JAX, twin, scan_steps(JAX))[0][0]
    port_counts = batches(PORT, twin, scan_steps(PORT))[0][0]
    assert jax_counts["catalog.row_compat"] == 2 * port_counts["catalog.row_compat"] > 0
    assert not any("uid" in k for k in list(jax_counts) + list(port_counts))
    _fused(monkeypatch, False)
    _delta(True)
    jg = batches(JAX, twin, group_steps(JAX))
    tg = batches(PORT, twin, group_steps(PORT))
    assert any(c.get("packer.delta_scatter") for c, _ in jg)
    assert any(c.get("packer.delta_pass") for c, _ in tg)
    assert not any("packer.delta_scatter" in c or "packer.solve_block_core" in c for c, _ in tg)


def test_delta_view_is_served(twin, monkeypatch):
    """/debug/kernels?view=delta: the registry serves ops/delta.debug_view()
    in both packages: the same sections, and the same scan residency
    after the same churn (the counters are process history)."""
    _fused(monkeypatch, True)
    _delta(True)
    seen = {}
    for pkg in PKGS:
        env = PkgEnv(pkg)
        for make in STREAM[:3]:
            env.schedule(make(pkg))
        view = twin[pkg].debug_snapshot(view="delta")
        assert view == _m(pkg, "ops.delta").debug_view()
        seen[pkg] = (sorted(view), [
            {k: r[k] for k in ("extendable", "last_outcome", "p_real", "passes")}
            for r in view["scan_residencies"]
        ])
    assert seen[PORT] == seen[JAX]
    assert seen[PORT][1] and seen[PORT][1][-1]["last_outcome"] == "warm"


# -- 3. the steady-batch floor ------------------------------------------------------


def floor_pods(pkg: str, n: int = 256) -> list:
    """tests/test_perf_floor.py's _plain_pods in either package."""
    core, res = _m(pkg, "apis.core"), _m(pkg, "utils.resources")
    cpus, mems = ["250m", "500m", "1", "2"], ["256Mi", "512Mi", "1Gi"]
    pods = []
    for i in range(n):
        p = core.Pod(
            metadata=core.ObjectMeta(name=f"od-{i:05d}", uid=f"od-uid-{i:05d}"),
            spec=core.PodSpec(containers=[core.Container(
                requests=res.parse_resource_list({"cpu": cpus[i % 4], "memory": mems[i % 3]}))]),
        )
        p.metadata.creation_timestamp = 0.0
        p.status.conditions.append(core.Condition(type="PodScheduled", status="False",
                                                  reason="Unschedulable"))
        pods.append(p)
    return pods


def steady_batch(pkg, reg) -> dict:
    env = PkgEnv(pkg)
    pods = floor_pods(pkg)
    results = env.schedule(pods)  # warmup
    assert not results.pod_errors
    reg.seal()
    try:
        with reg.batch_scope(label="perf-floor") as acc:
            results = env.schedule(pods)
    finally:
        reg.unseal()
    assert not results.pod_errors
    return {"kernels": dict(acc["kernels"]), "host_records": acc["host_records"]}


def test_reference_steady_batch_floor_with_scan_x64_patched(registries, monkeypatch):
    """The reference's own floor test passes once its scan runs under
    jax.enable_x64 (its scan_x64 imports a name jax 0.9 removed)."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    jfloor.TestOneDispatchFloor().test_steady_batch_is_one_device_dispatch()


def test_steady_batch_floor_on_both_packages(registries, monkeypatch):
    """A warm fused solve: the reference's steady batch is ONE dispatch,
    its sweep served by the host twin; the port's is the scan and the
    sweep, the designed "steady scan batch" difference — and the
    reference's own batch is the port's once its sweep is pinned to the
    device."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    _fused(monkeypatch, True)
    ref = steady_batch(JAX, registries[JAX])
    assert ref == {"kernels": {"packer.solve_scan": 1}, "host_records": 1}
    assert registries[JAX].debug_snapshot("feasibility.cube")["host_dispatches"] >= 1
    port = steady_batch(PORT, registries[PORT])
    assert port == {"kernels": {"feasibility.cube": 1, "packer.solve_scan": 1}, "host_records": 0}
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    assert steady_batch(JAX, registries[JAX]) == port
    last = registries[PORT].last_batches(1)[-1]
    assert last["label"] == "perf-floor" and last["dispatches"] == 2 and last["phase"] == "steady"


# -- 4. the scan's 27-operand shape signature ---------------------------------------


@pytest.mark.parametrize("variant", ["plain", "limits"])
def test_scan_signature_matches_and_parses_to_the_same_rung(twin, monkeypatch, variant):
    """The same fused solve's packer.solve_scan shape buckets in both
    registries: 27 segments, equal, and the ladder derives the same
    7-axis rung from either (aot/ladder._scan_signature_dims)."""
    _fused(monkeypatch, True)
    seen = {}
    for pkg in PKGS:
        s = tsolve.spec(1 if variant == "limits" else 0)
        if variant == "plain":
            s["pools"] = s["pools"][:1]
        scheduler, pods = tsolve.build_solve(pkg, s)
        scheduler.solve(pods)
        counts = twin[pkg].counts_snapshot()
        shapes = sorted(counts["packer.solve_scan"]["shapes"])
        ladder = _m(pkg, "aot.ladder").from_observatory(counts, headroom=0)
        seen[pkg] = (shapes, ladder.to_dict()["kernels"]["packer.solve_scan"])
    assert seen[PORT] == seen[JAX]
    (shape,) = seen[PORT][0]
    assert len(shape.split(",")) == 27
    rung = seen[PORT][1][0]
    assert len(rung) == 7 and (rung[6] > 0) == (variant == "limits"), rung


# -- 5. the fence -------------------------------------------------------------------


class FakeCuda:
    """A stand-in CUDA output: what the fence reads of a tensor."""

    is_cuda = True

    def __init__(self, index: int):
        self.device = torch.device("cuda", index)


class FakeEvent:
    """torch.cuda.Event's stand-in: records where it was recorded and
    synchronized; `fail` makes synchronize raise as a faulted card does."""

    log: list = []
    fail = False

    def record(self, stream):
        FakeEvent.log.append(("record", stream))

    def synchronize(self):
        FakeEvent.log.append(("synchronize",))
        if FakeEvent.fail:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(FakeEvent, "log", [])
    monkeypatch.setattr(FakeEvent, "fail", False)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: f"stream of {dev}")
    return FakeEvent


def test_fence_finds_cuda_outputs_only():
    out = (torch.ones(2), [FakeCuda(1), (FakeCuda(0), FakeCuda(1))], 3, None)
    assert tktime._cuda_devices(out) == [torch.device("cuda", 1), torch.device("cuda", 0)]
    assert tktime._cuda_devices((torch.ones(1), [torch.zeros(2)])) == []
    assert tktime._cuda_devices(FakeCuda(2)) == [torch.device("cuda", 2)]


def test_fence_records_and_waits_one_event_per_device(fake_events):
    tktime._fence((FakeCuda(0), [FakeCuda(0), FakeCuda(3)]))
    assert fake_events.log == [
        ("record", "stream of cuda:0"), ("synchronize",),
        ("record", "stream of cuda:3"), ("synchronize",),
    ]
    fake_events.log.clear()
    tktime._fence((torch.ones(3),))  # CPU outputs: nothing to wait for
    assert fake_events.log == []


def test_fault_at_the_fence_is_a_kernel_error(fake_events):
    fake_events.fail = True
    with pytest.raises(KernelError, match="illegal memory access") as info:
        with tktime.measure():
            tktime.dispatch(lambda: (FakeCuda(0),), kernel="spec.fault")
    assert isinstance(info.value.__cause__, RuntimeError)


def test_fence_only_with_a_measure_context_or_a_compile(registries, fake_build, monkeypatch):
    """The reference's rule: no context and no compile, no fence (the hot
    path stays asynchronous); a context, or a dispatch that built a
    library, fences."""
    fenced = []
    monkeypatch.setattr(tktime, "_fence", lambda out: fenced.append(out))
    tktime.dispatch(lambda: "a", kernel="spec.f")
    assert fenced == []
    with tktime.measure():
        tktime.dispatch(lambda: "b", kernel="spec.f")
    assert fenced == ["b"]

    def building():
        fake_build("spec_f")
        return "c"

    tktime.dispatch(building, kernel="spec.f")
    assert fenced == ["b", "c"]
    snap = registries[PORT].debug_snapshot("spec.f")
    assert snap["dispatches"] == 3 and snap["compiles"] == 1


def test_cpu_dispatch_never_compiles(registries):
    """On the CPU the port builds nothing: a solve's dispatches record no
    compile."""
    b0 = tdevice.build_count()
    scheduler, pods = tsolve.build_solve(PORT, tsolve.spec(2))
    scheduler.solve(pods)
    assert tdevice.build_count() == b0
    rows = registries[PORT].debug_snapshot()["kernels"]
    assert rows and all(r["compiles"] == 0 for r in rows)


def test_fault_at_the_fence_fails_the_solve(registries, fake_events, monkeypatch):
    """A fault that surfaces at the fence of the sweep fails the solve as a
    KernelError (the solve runs on a CPU engine; its sweep's output stands
    for a CUDA tensor), and the attempt leaves no device solve counted."""
    monkeypatch.setattr(tfused, "FUSED_MODE", "off")
    real = tktime._cuda_devices
    monkeypatch.setattr(tktime, "_cuda_devices",
                        lambda out: [torch.device("cuda", 0)] if real(out) == [] else real(out))
    fake_events.fail = True
    scheduler, pods = tsolve.build_solve(PORT, tsolve.spec(3))
    t0, f0 = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
    with pytest.raises(KernelError, match="fence"):
        with tktime.measure():
            scheduler.solve(pods)
    assert (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS) == (t0, f0)
    # without a measure() context nothing fences: the same solve succeeds
    scheduler, pods = tsolve.build_solve(PORT, tsolve.spec(3))
    assert scheduler.solve(pods).new_node_claims


def test_batch_timeline_splits_enqueue_and_block(registries):
    """A fenced dispatch's wall splits into enqueue and block in the batch
    timeline; the batch's host-stall fraction is in [0, 1]."""
    reg = registries[PORT]
    with reg.batch_scope(label="timeline") as acc:
        with tktime.measure() as m:
            tktime.dispatch(lambda x: x @ x, torch.ones(16, 16), kernel="spec.tl")
    assert acc["dispatches"] == acc["fenced"] == 1
    (event,) = acc["timeline"]
    assert event["kernel"] == "spec.tl" and event["fenced"] is True and event["shape"] == "16x16"
    assert m["enqueue_s"] > 0 and m["block_s"] >= 0
    assert 0.0 <= acc["host_stall_fraction"] <= 1.0
