"""The port's own rules for the simulator (karpenter_tpu_torch/sim/), beside
the twin files that hold it to the reference (tests/test_torch_sim_*.py):

- the run's device survives every engine rebuild — a solver-service
  restart, an operator crash restart, every cell of a fleet — on the CPU,
  and with a stand-in card the engine factory is asked for the card each
  time;
- `python -m karpenter_tpu_torch.sim` runs with the AOT flags (the report
  counts the warm start), exits 2 without a card, and never falls back to
  the CPU;
- a KernelError from a solve (through the flaky-solver wrapper too) or from
  a dying client's `close()` in a restart leaves `run()`, and `main` exits
  nonzero with the flight ring dumped;
- under the sim's pinned round trip both packages route every row batch
  and sweep alike: the kernels section, the last batch's dispatches, the
  delta counters and the flight ring and bundles are the reference's;
- each entry of `sim.harness.DEVICE_SPECIFIC` is shown to differ between the
  packages (or between the card's scan and a CPU engine's walk), while the
  event log and the rest of the report stay equal;
- the import rule covers sim/.
"""

from __future__ import annotations

import ast
import copy
import io
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402
from test_torch_observatory import as_port_counts  # noqa: E402

from karpenter_tpu_torch.controllers.provisioning import provisioner as provmod  # noqa: E402
from karpenter_tpu_torch.device import KernelError  # noqa: E402
from karpenter_tpu_torch.observability import explain as explmod  # noqa: E402
from karpenter_tpu_torch.observability import flight as flightmod  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as feas  # noqa: E402
from karpenter_tpu_torch.ops import fused  # noqa: E402
from karpenter_tpu_torch.sim import __main__ as sim_cli  # noqa: E402
from karpenter_tpu_torch.sim import harness, scenarios  # noqa: E402
from karpenter_tpu_torch.sim.fleet import FleetSimulation  # noqa: E402
from karpenter_tpu_torch.solverd import transport  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_MODULES = [
    "__init__.py", "__main__.py", "accounting.py", "events.py", "faults.py", "fleet.py",
    "harness.py", "trace.py", "scenarios/__init__.py",
]


def tiny_trace(*events, duration=40.0, faults=None):
    """A version-1 trace: one pool, three pods at 2 s, then `events`."""
    return {
        "version": 1,
        "name": "port-rules",
        "duration": duration,
        "tick": 1.0,
        "nodepools": [{"name": "workers"}],
        "faults": faults or {},
        "events": [
            {"at": 2.0, "kind": "submit", "group": "web", "count": 3,
             "pod": {"cpu": "1"}, "replace": True},
            *events,
        ],
    }


@pytest.fixture
def factory_calls(monkeypatch):
    """Every default_engine_factory call's device; the engines are built on
    the CPU whatever was asked (a stand-in card)."""
    calls = []
    real = provmod.default_engine_factory

    def factory(shard_devices=0, device=None):
        calls.append(device)
        return real(shard_devices, device="cpu")

    monkeypatch.setattr(provmod, "default_engine_factory", factory)
    return calls


# -- the device through every rebuild -------------------------------------------


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_device_survives_a_solver_restart(factory_calls, device):
    trace = tiny_trace({"at": 10.0, "kind": "solverd-restart"},
                       {"at": 20.0, "kind": "solverd-restart"})
    result = harness.run_scenario(trace, 3, device=device)
    assert len(result.log.entries("solverd-restart")) == 2
    # the Operator's factory, then one a restart
    assert factory_calls == [device] * 3


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_device_survives_a_crash_restart(factory_calls, device):
    trace = tiny_trace({"at": 2.0, "kind": "operator-crash", "barrier": "pre-intent"},
                       duration=60.0)
    result = harness.run_scenario(trace, 3, device=device)
    crashes = result.report["recovery"]["crashes"]
    assert crashes >= 1
    assert factory_calls == [device] * (1 + crashes)


def test_cpu_engines_stay_on_the_cpu(monkeypatch):
    """No factory stand-in: every engine the run builds lies on the CPU,
    through both kinds of restart."""
    from karpenter_tpu_torch.ops import catalog

    devices = []

    class Recorded(catalog.CatalogEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            devices.append(self.device.type)

    monkeypatch.setattr(catalog, "CatalogEngine", Recorded)
    trace = tiny_trace({"at": 10.0, "kind": "solverd-restart"},
                       {"at": 14.0, "kind": "submit", "group": "more", "count": 2,
                        "pod": {"cpu": "2"}},
                       {"at": 20.0, "kind": "operator-crash", "barrier": "pre-intent"},
                       {"at": 24.0, "kind": "submit", "group": "late", "count": 2,
                        "pod": {"cpu": "3"}},
                       duration=80.0)
    harness.run_scenario(trace, 5, device="cpu")
    assert len(devices) >= 2 and set(devices) == {"cpu"}, devices


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_every_fleet_cell_on_the_run_device(factory_calls, device):
    trace = scenarios.resolve("fleet-replica-kill", 11)
    sim = FleetSimulation(trace, 11, device=device)
    try:
        assert factory_calls == [device] * len(trace["tenants"])
        assert [cell.device for cell in sim.cells] == [device] * len(trace["tenants"])
    finally:
        # never run: the cells' operators leave the process-global flight
        # recorder and SLO engine as they found them
        for cell in sim.cells:
            cell.operator.shutdown()
        sim.tracer.close()


def test_cpu_engine_mesh_repeats_the_cpu(monkeypatch):
    """`--shard-devices N --device cpu` on a machine with a card: the CPU
    engine's mesh is the CPU N times, never the cards (a CUDA mesh would
    fail the engine's build)."""
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types

    monkeypatch.setattr(provmod, "_build_solver_mesh", pytest.fail)
    monkeypatch.setattr(provmod, "_ENGINE_CONTENT_CACHE", {})
    catalog = {"workers": construct_instance_types()[:8]}
    for n in (1, 2):
        engine = provmod.default_engine_factory(shard_devices=n, device="cpu")(catalog)
        assert [d.type for d in engine.mesh.devices] == ["cpu"] * n
    assert provmod.default_engine_factory(shard_devices=0, device="cpu")(catalog).mesh is None


def test_mesh_sweep_digest_equal_across_cpu_mesh_sizes():
    """The mesh-sweep scenario's contract on the port's CPU meshes: the same
    event log at 0, 1 and 2 shards, the sweeps through the sharded cube."""
    from karpenter_tpu_torch.operator.options import Options

    results = [
        harness.run_scenario(scenarios.resolve("mesh-sweep", 7), 7, device="cpu",
                             options=Options(solver_pod_shard_axis=n) if n else None)
        for n in (0, 1, 2)
    ]
    assert len({r.digest for r in results}) == 1
    assert "feasibility.cube_sharded" in results[2].report["kernels"]["kernels"]
    assert "feasibility.cube_sharded" not in results[0].report["kernels"]["kernels"]


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("flag", [["--aot-ladder", "default"], ["--compile-cache-dir", None]])
def test_main_exits_2_on_the_aot_flags(flag, monkeypatch, capsys, tmp_path):
    """The AOT flags run the simulator (they exited 2 before the port had
    its AOT compiler): the report's kernels.aot counts the boot's warm
    start, on the CPU engines."""
    import json

    flag = [str(tmp_path / "cache") if f is None else f for f in flag]
    tw.reset_aot(tw.T)
    try:
        assert sim_cli.main(["-s", "steady-state", "--seed", "7", "--device", "cpu", *flag]) == 0
    finally:
        tw.reset_aot(tw.T)
    report = json.loads(capsys.readouterr().out)
    assert report["kernels"]["aot"]["warm_starts"] >= 1
    assert report["kernels"]["aot"]["fresh_compiles"] > 0
    if "--compile-cache-dir" in flag:
        assert any(n.endswith(".aotx") for n in os.listdir(tmp_path / "cache"))


@pytest.mark.parametrize("argv", [[], ["-s", "steady-state"], ["-s", "steady-state", "--device", "cuda"]])
def test_main_without_a_card_exits_2_and_never_falls_back(argv, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sim_cli, "run_scenario", pytest.fail)
    assert sim_cli.main(argv) == 2
    assert "CUDA is not available" in capsys.readouterr().err


def test_main_passes_its_device_to_the_run(monkeypatch, tmp_path):
    seen = []
    real = harness.run_scenario

    def run(*args, device=None, **kwargs):
        seen.append(device)
        return real(*args, device=device, **kwargs)

    monkeypatch.setattr(sim_cli, "run_scenario", run)
    report = tmp_path / "r.json"
    assert sim_cli.main(["--trace", _write(tmp_path, tiny_trace()), "--device", "cpu",
                         "--report", str(report)]) == 0
    assert seen == ["cpu"] and report.exists()


def _write(tmp_path, trace) -> str:
    from karpenter_tpu_torch.sim import trace as tracemod

    path = tmp_path / "trace.json"
    path.write_text(tracemod.dumps(trace))
    return str(path)


# -- a device fault ends the run ------------------------------------------------


@pytest.fixture
def faulting_sweep(monkeypatch):
    """Every sweep of the catalog engine raises KernelError, as a fault
    fenced on the card would; every sweep is routed to the device
    (FORCE_BACKEND overrides the sim's pinned round trip), where the
    launch is."""

    def cube_rows(*args):
        raise KernelError("stand-in device fault in kt_cube")

    monkeypatch.setattr(feas, "cube_rows", cube_rows)
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")


def test_kernel_error_from_a_solve_leaves_run(faulting_sweep):
    with pytest.raises(KernelError, match="stand-in"):
        harness.run_scenario(tiny_trace(), 3, device="cpu")


def test_kernel_error_through_the_flaky_solver_leaves_run(faulting_sweep):
    trace = tiny_trace(faults={"solver_rejection_rate": 0.3})
    with pytest.raises(KernelError, match="stand-in"):
        harness.run_scenario(trace, 3, device="cpu")


def test_main_exits_nonzero_on_a_kernel_error(faulting_sweep, tmp_path):
    from karpenter_tpu_torch.operator import logging as klog

    stream = io.StringIO()
    klog.configure("info", stream=stream)
    try:
        rc = sim_cli.main(["--trace", _write(tmp_path, tiny_trace()), "--device", "cpu",
                           "--log-level", "info"])
    finally:
        klog.configure("warning", stream=sys.stderr)
    err = stream.getvalue()
    assert rc == 1
    assert "simulation failed on a device fault" in err and "KernelError" in err
    assert "flight-0001-sim-device-fault" in err


@pytest.mark.parametrize("event", [
    {"at": 10.0, "kind": "solverd-restart"},
    {"at": 2.0, "kind": "operator-crash", "barrier": "pre-intent"},
])
def test_kernel_error_from_close_in_a_restart_leaves_run(event, monkeypatch):
    def close(self):
        raise KernelError("stand-in fault while the service drains")

    monkeypatch.setattr(transport.InProcessClient, "close", close)
    with pytest.raises(KernelError, match="drains"):
        harness.run_scenario(tiny_trace(event, duration=60.0), 3, device="cpu")


@pytest.mark.parametrize("event", [
    {"at": 10.0, "kind": "solverd-restart"},
    {"at": 2.0, "kind": "operator-crash", "barrier": "pre-intent"},
])
def test_plain_error_from_close_in_a_restart_is_swallowed(event, monkeypatch):
    """The reference's rule for a dying client stays: any other error of
    its close() in a restart does not stop the run."""
    real, calls = transport.InProcessClient.close, []

    def close(self):
        calls.append(self)
        if len(calls) == 1:  # the restart's; the run's shutdown closes cleanly
            raise RuntimeError("a dying daemon")
        return real(self)

    monkeypatch.setattr(transport.InProcessClient, "close", close)
    result = harness.run_scenario(tiny_trace(event, duration=60.0), 3, device="cpu")
    assert len(calls) >= 2
    assert result.report["slo"]["pods_never_bound"] == 0


# -- DEVICE_SPECIFIC, one entry at a time ------------------------------------------


def _run_both(name, seed=7, force_device=False, **port_kwargs):
    """`name` on the reference (ffd.STRICT) and on the port's CPU engines,
    both under the sim's pinned round trip or, when asked, both pinned to
    the device (FORCE_BACKEND="device"); each result with its flight
    recorder's ring and bundles as they stood at the end of the run."""
    from karpenter_tpu.observability import flight as jflight
    from karpenter_tpu.ops import catalog as jcatalog
    from karpenter_tpu.ops import ffd as jffd
    from karpenter_tpu.sim import harness as jharness
    from karpenter_tpu.sim import scenarios as jscenarios
    from karpenter_tpu_torch.ops import catalog as tcatalog

    from karpenter_tpu.ops import delta as jdelta
    from karpenter_tpu_torch.ops import delta as tdelta

    options = port_kwargs.pop("options", None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jffd, "STRICT", True)
        # a report's solver.delta is the process's delta counters: each run
        # counts from 0, as in a process of its own (torch_twins does the same)
        for mod in (jdelta, tdelta):
            mp.setattr(mod, "COUNTERS", dict.fromkeys(mod.COUNTERS, 0))
        if force_device:
            for cat in (jcatalog, tcatalog):
                mp.setattr(cat, "FORCE_BACKEND", "device")
        ref = jharness.run_scenario(jscenarios.resolve(name, seed), seed,
                                    options=options and options[0])
        ref_flight = (list(jflight.recorder()._ring), list(jflight.recorder()._bundles))
        port = harness.run_scenario(scenarios.resolve(name, seed), seed, device="cpu",
                                    options=options and options[1], **port_kwargs)
        port_flight = (list(flightmod.recorder()._ring), list(flightmod.recorder()._bundles))
    return (ref, ref_flight), (port, port_flight)


@pytest.fixture(scope="module")
def steady():
    return _run_both("steady-state")


def test_equal_outside_device_specific(steady):
    """steady-state never dispatches to the device under the pin: the
    whole report is the reference's."""
    (ref, _), (port, _) = steady
    assert port.digest == ref.digest
    assert port.log.to_jsonl() == ref.log.to_jsonl()
    assert harness.report_without(port.report) == harness.report_without(ref.report)
    assert port.report == ref.report


def test_kernels_differ_by_the_host_route(steady):
    """The host route no longer sets the packages apart: under the pinned
    RTT both send steady-state's small row batches and sweeps to their
    host twins, under the same shape buckets, so the kernels section and
    its digest are the reference's."""
    (ref, _), (port, _) = steady
    rk, pk = ref.report["kernels"]["kernels"], port.report["kernels"]["kernels"]
    for name in ("catalog.row_compat", "feasibility.cube"):
        assert rk[name]["dispatches"] == 0 and rk[name]["host_dispatches"] > 0, rk[name]
    assert pk == rk
    assert ref.report["kernels"]["digest"] == port.report["kernels"]["digest"]
    assert ref.report["kernels"]["efficiency"] == port.report["kernels"]["efficiency"]
    assert port.report["kernels"]["efficiency"]["host_stall_fraction"] == 1.0


def test_kernels_dispatch_counts_match_the_reference_pinned_to_the_device():
    """FORCE_BACKEND="device" overrides the pin in both packages: the
    dispatch counts are then the reference's through as_port_counts (one
    row dispatch a batch where the reference makes two)."""
    (ref, _), (port, _) = _run_both("steady-state", force_device=True)
    assert port.digest == ref.digest
    want = as_port_counts({k: v["dispatches"] for k, v in ref.report["kernels"]["kernels"].items()})
    got = {k: v["dispatches"] for k, v in port.report["kernels"]["kernels"].items()}
    assert got == want and got["feasibility.cube"] > 0
    assert all(v["host_dispatches"] == 0 for v in port.report["kernels"]["kernels"].values())
    assert ref.report["kernels"]["steady_recompiles"] == port.report["kernels"]["steady_recompiles"] == 0


def test_last_batch_dispatches_differ_by_the_host_route(steady):
    """The last batch's device dispatches: 0 in both packages, whose host
    twins served it."""
    (ref, _), (port, _) = steady
    assert ref.report["solver"]["last_batch_dispatches"] == 0
    assert port.report["solver"]["last_batch_dispatches"] == 0


def test_device_appended_rows_differ_by_the_host_route():
    """With delta solves on, neither package meters a device-appended row:
    the reference's delta-warm exception asks for a resident copy its
    cache never stores, and the port asks its cache the same question. The
    port's resident matrices still hold every row (appended, unmetered)."""
    from karpenter_tpu.ops import delta as jdelta
    from karpenter_tpu_torch.ops import delta as tdelta

    try:
        for mod in (jdelta, tdelta):
            mod.configure(mode="on")
        (ref, _), (port, _) = _run_both("sustained-churn")
    finally:
        for mod in (jdelta, tdelta):
            mod.configure(mode="off")
    assert port.digest == ref.digest
    assert "delta_rows_device_appended" not in ref.report["solver"]["delta"]
    assert "delta_rows_device_appended" not in port.report["solver"]["delta"]
    assert port.report["solver"]["delta"] == ref.report["solver"]["delta"]
    assert harness.report_without(port.report) == harness.report_without(ref.report)


def _without_kernels_source(frames):
    out = []
    for frame in frames:
        frame = flightmod.scrub(copy.deepcopy(frame))
        kernels = frame["sources"].pop("kernels")
        out.append((frame, kernels))
    return [f for f, _ in out], [k for _, k in out]


def test_flight_ring_digest_differs_by_the_kernels_source():
    """tpu-training's ring holds every pass of its run; the kernels source
    of each frame (the pass's dispatch deltas, host records included) is
    the reference's now that both route alike, and so is the digest."""
    (ref, (ref_ring, _)), (port, (port_ring, _)) = _run_both("tpu-training")
    assert port.digest == ref.digest
    assert ref.report["flight"]["ring_digest"] == port.report["flight"]["ring_digest"]
    ref_frames, ref_kernels = _without_kernels_source(ref_ring)
    port_frames, port_kernels = _without_kernels_source(port_ring)
    assert ref_frames == port_frames and ref_frames
    assert ref_kernels == port_kernels and any(ref_kernels)


def test_flight_bundle_sha256_differs_by_the_kernels_source():
    """spot-interruption's bundles: digests over the same frames, equal."""
    (ref, (_, ref_bundles)), (port, (_, port_bundles)) = _run_both("spot-interruption")
    assert port.digest == ref.digest
    rb, pb = ref.report["flight"]["bundles"], port.report["flight"]["bundles"]
    assert rb and rb == pb
    for a, b in zip(ref_bundles, port_bundles):
        assert flightmod.scrub(copy.deepcopy(a["_frames"])) == \
            flightmod.scrub(copy.deepcopy(b["_frames"]))


@pytest.mark.parametrize("shards", [0, 2])
def test_kernels_shapes_differ_by_the_device_sweep_bucket(shards):
    """mesh-sweep's wide priming sweep goes to the device under the pin in
    both packages (one dispatch each, unsharded or on a 2-shard mesh): the
    counts agree, the sweep's shape bucket and so the digest differ, every
    host record's bucket agrees, and nothing else of the report differs."""
    from karpenter_tpu.operator.options import Options as JOptions
    from karpenter_tpu_torch.operator.options import Options as TOptions

    options = (JOptions(solver_pod_shard_axis=shards), TOptions(solver_pod_shard_axis=shards)) \
        if shards else None
    (ref, _), (port, _) = _run_both("mesh-sweep", options=options)
    assert port.digest == ref.digest
    name = "feasibility.cube_sharded" if shards else "feasibility.cube"
    rk, pk = ref.report["kernels"]["kernels"], port.report["kernels"]["kernels"]
    assert set(rk) == set(pk) and rk[name]["dispatches"] == pk[name]["dispatches"] > 0
    for k in rk:
        for field in ("dispatches", "host_dispatches", "phases"):
            assert rk[k][field] == pk[k][field], (k, field)
        host = lambda shapes: {s: ph for s, ph in shapes.items() if set(ph) == {"host"}}  # noqa: E731
        assert host(rk[k]["shapes"]) == host(pk[k]["shapes"]), k
    assert rk[name]["shapes"] != pk[name]["shapes"]
    assert ref.report["kernels"]["digest"] != port.report["kernels"]["digest"]
    assert harness.report_without(port.report, harness.DEVICE_SPECIFIC + harness.VOLATILE) == \
        harness.report_without(ref.report, harness.DEVICE_SPECIFIC + harness.VOLATILE)


def test_explain_fused_declines_differ_by_the_scan(monkeypatch):
    """The card's `auto` tries the scan on a batch of 64 pods or more; a CPU
    engine runs the walk. Forced on, the CPU engine stands in for the card:
    a zone-spread batch declines it (`topo`), the plain batch runs it, and
    only the decline taxonomy and the scan's dispatches (the kernels
    section, the flight frames' kernels source) tell the runs apart."""
    trace = {
        "version": 1, "name": "explain-scan", "duration": 40.0, "tick": 2.0,
        "nodepools": [{"name": "workers"}],
        "events": [
            {"at": 2.0, "kind": "submit", "group": "web", "count": 70,
             "pod": {"cpu": "500m", "memory": "512Mi"}},
            {"at": 10.0, "kind": "submit", "group": "spread", "count": 70,
             "pod": {"cpu": "250m", "spread": "zone"}},
        ],
    }
    # every decline reason new to the process: the solver service's counter
    # deltas must take a counter born during the solve (it raised KeyError)
    monkeypatch.setattr(fused, "FUSED_DECLINES", {})
    previous = explmod.recorder().mode
    explmod.configure(mode="on")
    runs = {}
    try:
        for mode in ("auto", "on"):
            monkeypatch.setattr(fused, "FUSED_MODE", mode)
            solves = fused.FUSED_SOLVES
            runs[mode] = harness.run_scenario(copy.deepcopy(trace), 3, device="cpu")
            runs[mode].fused_solves = fused.FUSED_SOLVES - solves
    finally:
        explmod.configure(mode=previous)
    walk, scan = runs["auto"], runs["on"]
    assert walk.fused_solves == 0 and scan.fused_solves >= 1
    assert walk.report["explain"]["fused_declines"] == {}
    assert scan.report["explain"]["fused_declines"].get("topo", 0) >= 1
    assert scan.digest == walk.digest
    assert scan.report["explain"]["digest"] == walk.report["explain"]["digest"]
    assert "packer.solve_scan" in scan.report["kernels"]["kernels"]
    assert "packer.solve_scan" not in walk.report["kernels"]["kernels"]
    no_kernels = harness.DEVICE_SPECIFIC + tuple(
        (path, "the scan's dispatches") for path in
        (("kernels",), ("flight", "ring_digest"), ("flight", "bundles", "*", "sha256")))
    assert harness.report_without(scan.report, no_kernels) == \
        harness.report_without(walk.report, no_kernels)


def test_report_without_reaches_lists_and_tenants():
    report = {
        "explain": {"fused_declines": {"topo": 1}, "digest": "e"},
        "solver": {"last_batch_dispatches": 3, "batches": 2},
        "tenants": {"t": {"explain": {"fused_declines": {}, "digest": "f"}}},
        "kernels": {"efficiency": {"host_stall_fraction": 0.5, "steady_batches": 2},
                    "digest": "d", "kernels": {"feasibility.cube": {"shapes": {}, "dispatches": 1}}},
    }
    assert harness.report_without(report) == {
        "explain": {"digest": "e"},
        "solver": {"last_batch_dispatches": 3, "batches": 2},
        "tenants": {"t": {"explain": {"digest": "f"}}},
        "kernels": {"efficiency": {"host_stall_fraction": 0.5, "steady_batches": 2},
                    "kernels": {"feasibility.cube": {"dispatches": 1}}},
    }
    stable = harness.report_without(report, harness.VOLATILE)
    assert stable["kernels"]["efficiency"] == {"steady_batches": 2}
    bundles = {"flight": {"ring_digest": "x", "bundles": [{"name": "a", "sha256": "1"}]}}
    assert harness.report_without(bundles, ((("flight", "bundles", "*", "sha256"), "a list"),)) == \
        {"flight": {"ring_digest": "x", "bundles": [{"name": "a"}]}}
    assert report["kernels"]["efficiency"]["host_stall_fraction"] == 0.5  # a copy
    assert all(reason for _path, reason in harness.DEVICE_SPECIFIC + harness.VOLATILE)


# -- the import rule --------------------------------------------------------------


def test_import_rule_covers_sim():
    from test_torch_feasibility import _port_files

    files = set(_port_files())
    sim = [os.path.join(REPO, "karpenter_tpu_torch", "sim", rel) for rel in SIM_MODULES]
    assert set(sim) <= files
    for path in sim:
        for node in ast.walk(ast.parse(open(path).read())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "karpenter_tpu"), (path, name)
    # the port holds every module of the reference's sim/
    ref_root = os.path.join(REPO, "karpenter_tpu", "sim")
    ref = sorted(os.path.relpath(os.path.join(root, f), ref_root)
                 for root, _dirs, names in os.walk(ref_root) for f in names if f.endswith(".py"))
    assert ref == sorted(SIM_MODULES)
