"""A device fault stops the operator's pass; a plain exception is still
isolated.

The reference's reconciler harness catches every exception of a
controller, counts it, backs the item off and lets the pass go on; its
binary's loop survives any exception of a pass. The port holds a
`KernelError` apart: the harness counts it as any error
(`karpenter_reconcile_errors_total`, the health ledger, the span) and
raises it, so `Operator.run_once()` fails on a device fault from the
Provisioner's solve, from the disruption controller, or through the
sidecar's socket; `python -m karpenter_tpu_torch` then dumps the flight
ring, shuts down and exits nonzero. The faults here are stand-ins injected
at the solver client; everything runs on CPU engines."""

from __future__ import annotations

import io
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

J, T = tw.J, tw.T


def _kernel_error():
    from karpenter_tpu_torch.device import KernelError

    return KernelError


def _operator(pkg: str, options=None):
    """An Operator on a FakeClock over the kwok provider, with one
    `workers` pool (consolidateAfter 0) and eight pending 1-cpu pods; the
    port's engines on the CPU."""
    h = tw.module("helpers", pkg)
    clock = tw._m(pkg, "utils.clock").FakeClock()
    store = tw._m(pkg, "runtime.store").Store(clock=clock)
    provider = tw._m(pkg, "cloudprovider.kwok.provider").KwokCloudProvider(store, clock)
    options = options or tw._m(pkg, "operator.options").Options()
    factory = None
    if pkg == T and options.solver_backend == "tpu" and options.solver_transport == "inprocess":
        factory = tw._m(T, "controllers.provisioning.provisioner").default_engine_factory(
            device="cpu"
        )
    op = tw._m(pkg, "operator.operator").Operator(
        store, provider, clock=clock, options=options, engine_factory=factory
    )
    pool = h.nodepool("workers")
    pool.spec.disruption.consolidate_after = 0.0
    store.create(pool)
    pods = [store.create(h.unschedulable_pod(requests={"cpu": "1"})) for _ in range(8)]
    return clock, store, op, pods


def _errors(pkg: str, controller: str) -> float:
    return tw._m(pkg, "operator.harness").RECONCILE_ERRORS.value({"controller": controller})


def _raising(err):
    def fail(*args, **kwargs):
        raise err

    return fail


def _retries(op, controller: str) -> int:
    return op.harness.limiter.retries((controller, ""))


def test_provisioner_kernel_error_leaves_run_once():
    KernelError = _kernel_error()
    with tw.leg(T):
        clock, store, op, _ = _operator(T)
        op.provisioner.solver.solve = _raising(KernelError("kt_cube: cudaError 700"))
        before = _errors(T, "provisioning")
        with pytest.raises(KernelError, match="cudaError 700"):
            for _ in range(4):
                clock.step(2.0)
                op.run_once()
        assert _errors(T, "provisioning") == before + 1
        assert op.harness._errors == {"provisioning": 1}
        assert op.harness._last_error["provisioning"] == "KernelError: kt_cube: cudaError 700"
        # counted, never backed off: the item is not deferred
        assert _retries(op, "provisioning") == 0
        op.shutdown()


def test_provisioner_kernel_error_from_a_kernel_wrapper(monkeypatch):
    """The fault raised where a launch would raise it: the CPU engine's
    feasibility sweep, routed to the device (the batch is small enough
    for the host twin otherwise)."""
    KernelError = _kernel_error()
    feas = tw._m(T, "ops.feasibility")
    monkeypatch.setattr(tw._m(T, "ops.catalog"), "FORCE_BACKEND", "device")
    monkeypatch.setattr(feas, "cube_rows", _raising(KernelError("kt_cube: cudaError 700")))
    with tw.leg(T):
        clock, store, op, _ = _operator(T)
        with pytest.raises(KernelError, match="cudaError 700"):
            for _ in range(4):
                clock.step(2.0)
                op.run_once()
        assert op.harness._errors == {"provisioning": 1}
        assert not store.list("NodeClaim")
        op.shutdown()


def _settled(pkg: str):
    """Eight pods bound on one kwok node; then every second pod deleted, so
    the node is underutilized and the disruption controller simulates."""
    clock, store, op, pods = _operator(pkg)
    for _ in range(6):
        clock.step(2.0)
        op.run_once()
    assert store.list("Node") and all(p.spec.node_name for p in store.list("Pod"))
    for p in pods[::2]:
        store.delete(store.get("Pod", p.metadata.name))
    return clock, store, op


def test_disruption_kernel_error_leaves_run_once():
    KernelError = _kernel_error()
    with tw.leg(T):
        clock, store, op = _settled(T)
        op.provisioner.solver.solve_many = _raising(KernelError("kt_solve_scan: cudaError 700"))
        before = _errors(T, "disruption")
        with pytest.raises(KernelError, match="cudaError 700"):
            for _ in range(10):
                clock.step(2.0)
                op.run_once()
        assert _errors(T, "disruption") == before + 1
        assert op.harness._errors == {"disruption": 1}
        assert _retries(op, "disruption") == 0
        op.shutdown()


def test_kernel_error_through_the_sidecar_leaves_run_once():
    """The daemon's device fault crosses the socket typed and fails the
    operator's pass."""
    sd = tw._m(T, "solverd")
    KernelError = _kernel_error()
    Clock = tw._m(T, "utils.clock").Clock

    def failing(catalog):
        raise KernelError("kt_row_compat: cudaError 700")

    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(svc, address="127.0.0.1:0", engine_factory=failing).start()
    try:
        with tw.leg(T):
            options = tw._m(T, "operator.options").Options(
                solver_transport="socket", solver_daemon_address=daemon.address
            )
            clock, store, op, _ = _operator(T, options)
            with pytest.raises(KernelError, match="cudaError 700"):
                for _ in range(4):
                    clock.step(2.0)
                    op.run_once()
            assert op.harness._errors == {"provisioning": 1}
            op.shutdown()
    finally:
        daemon.stop()
        svc.close()


@pytest.mark.parametrize("controller", ["provisioning", "disruption"])
def test_plain_exception_is_isolated_as_in_the_reference(controller):
    """A plain exception is counted, backed off, and the pass goes on: the
    same harness state in both packages."""
    seen = {}
    for pkg in (J, T):
        with tw.leg(pkg):
            if controller == "provisioning":
                clock, store, op, _ = _operator(pkg)
                op.provisioner.solver.solve = _raising(RuntimeError("boom"))
            else:
                clock, store, op = _settled(pkg)
                op.provisioner.solver.solve_many = _raising(RuntimeError("boom"))
            before = _errors(pkg, controller)
            summaries = []
            for _ in range(6):
                clock.step(2.0)
                summaries.append(op.run_once())
            assert _errors(pkg, controller) > before
            assert _retries(op, controller) >= 1
            seen[pkg] = (
                summaries,
                sorted(op.harness._errors.items()),
                op.harness._last_error.get(controller),
                _retries(op, controller),
                _errors(pkg, controller) - before,
            )
            op.shutdown()
    assert seen[T] == seen[J]
    assert seen[T][2] == "RuntimeError: boom"


def _main(monkeypatch, argv, fault=None, max_passes=5):
    """`python -m karpenter_tpu_torch`'s main with its log captured; `fault`
    is raised by every pass."""
    cli = tw._m(T, "__main__")
    klog = tw._m(T, "operator.logging")
    if fault is not None:
        monkeypatch.setattr(cli.Operator, "run_once", _raising(fault))
    stream = io.StringIO()
    klog.configure("info", stream=stream)
    try:
        rc = cli.main(argv=argv, max_passes=max_passes, pass_interval=0.0)
    finally:
        klog.configure("info", stream=sys.stderr)
    return rc, [json.loads(line) for line in stream.getvalue().splitlines()]


CPU = ["--device", "cpu", "--metrics-port", "0", "--health-probe-port", "0"]


def test_main_exits_nonzero_on_a_kernel_error(monkeypatch):
    KernelError = _kernel_error()
    rc, lines = _main(monkeypatch, CPU, KernelError("kt_solve_scan: cudaError 700"))
    assert rc == 1
    messages = [e["message"] for e in lines]
    assert "reconcile pass failed on a device fault; stopping" in messages
    dumped = [e for e in lines if e["message"] == "flight bundle dumped"]
    assert dumped and "device-fault" in dumped[0]["bundle"]
    stopped = [e for e in lines if e["message"] == "operator stopped"]
    assert stopped and stopped[0]["passes"] == 1


def test_main_survives_a_plain_exception(monkeypatch):
    """The reference's loop, kept: a plain exception is logged and the loop
    runs on to its last pass."""
    rc, lines = _main(monkeypatch, CPU, RuntimeError("boom"), max_passes=3)
    assert rc == 0
    assert [e["message"] for e in lines].count("reconcile pass failed") == 3
    stopped = [e for e in lines if e["message"] == "operator stopped"]
    assert stopped and stopped[0]["passes"] == 3


def test_main_runs_passes_on_the_cpu(monkeypatch):
    rc, lines = _main(monkeypatch, CPU, max_passes=2)
    assert rc == 0
    assert any(e["message"] == "operator stopped" and e["passes"] == 2 for e in lines)


def _with_a_nodepool(monkeypatch):
    """The binary's store holds a Ready NodePool, so its first pass prewarms
    an engine."""
    cli = tw._m(T, "__main__")
    helpers = tw.module("helpers", T)
    real = cli.Store

    def store(*args, **kwargs):
        s = real(*args, **kwargs)
        s.create(helpers.nodepool("workers"))
        return s

    monkeypatch.setattr(cli, "Store", store)


@pytest.fixture
def aot_reset():
    """No AOT state before and after the case (a content-cached engine
    would be warm already)."""
    tw.reset_aot(T)
    yield tw._m(T, "aot.runtime")
    tw.reset_aot(T)


@pytest.mark.parametrize("flags", [["--aot-ladder", "default"], ["--compile-cache-dir", None]])
def test_main_exits_2_on_the_aot_flags(monkeypatch, tmp_path, aot_reset, flags):
    """The AOT flags boot the binary (they exited 2 before the port had its
    AOT compiler): the first pass warm-starts the CPU engine on the default
    ladder, with a cache directory when one is given."""
    flags = [str(tmp_path / "cache") if f is None else f for f in flags]
    _with_a_nodepool(monkeypatch)
    base = aot_reset.stats()
    rc, lines = _main(monkeypatch, CPU + flags, max_passes=2)
    assert rc == 0
    assert aot_reset.stats_delta(base)["warm_starts"] == 1
    walks = [e for e in lines if e["message"] == "AOT warm start complete"]
    assert walks and walks[0]["fresh_compiles"] == walks[0]["buckets"] > 0
    if "--compile-cache-dir" in flags:
        assert any(n.endswith(".aotx") for n in os.listdir(tmp_path / "cache"))


def test_main_exits_1_on_a_kernel_error_in_the_warm_start(monkeypatch, tmp_path, aot_reset):
    """port: a KernelError in a bucket's warm launch stops the binary with
    exit 1 and names it — no lazy fallback (the reference's warm start logs
    it and boots on)."""
    KernelError = _kernel_error()
    compiler = tw._m(T, "aot.compiler")

    def warm(self):
        raise KernelError(f"warm start of {self.kernel} at {self.sig}: cudaError 700")

    monkeypatch.setattr(compiler.Executable, "warm", warm)
    _with_a_nodepool(monkeypatch)
    rc, lines = _main(monkeypatch, CPU + ["--compile-cache-dir", str(tmp_path)])
    assert rc == 1
    messages = [e["message"] for e in lines]
    assert "reconcile pass failed on a device fault; stopping" in messages
    assert "KernelError" in json.dumps(lines)
    assert "AOT warm start complete" not in messages


def test_main_without_a_card_exits_2_and_never_falls_back(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    cli = tw._m(T, "__main__")
    monkeypatch.setattr(cli, "Operator", lambda *a, **k: built.append(1))
    for argv in (["--metrics-port", "0"], ["--device", "cuda", "--metrics-port", "0"]):
        rc, _ = _main(monkeypatch, argv)
        assert rc == 2
    assert not built
