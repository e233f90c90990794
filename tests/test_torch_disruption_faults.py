"""A device fault on the consolidation path fails the pass; a solver's
rejection still defers it.

The reference keeps sequential semantics for a frontier round's errors: a
probe's error surfaces only if the walk reaches that probe, and the
disruption controller backs off on `SolverRejection` / `TransportError`.
The port holds a `KernelError` apart: any probe's, walked or speculative,
fails the compute (`FrontierSimulator.solve_batch`), it crosses the
sidecar's socket typed (`transport._ERROR_TYPES`), and it propagates out of
`DisruptionController.reconcile()` instead of turning into a back-off.
The faults here are stand-ins injected at the solver client; everything
runs on CPU engines."""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402

T = tw.T


def _frontier():
    return tw.module("test_frontier", T)


def _sd():
    from karpenter_tpu_torch import solverd

    return solverd


def _kernel_error():
    from karpenter_tpu_torch.device import KernelError

    return KernelError


def _inject(solver, round_index: int, pos: int, err: Exception) -> None:
    """Round `round_index`'s probe `pos` comes back carrying `err`."""
    real = solver.solve_many
    calls = [0]

    def solve_many(kind, batch, *args, **kwargs):
        out = list(real(kind, batch, *args, **kwargs))
        if calls[0] == round_index and pos < len(out):
            out[pos] = (None, err)
        calls[0] += 1
        return out

    solver.solve_many = solve_many


def _compute(method_name: str, seed: int, fault=None):
    """One compute_command on a fresh seeded env; `fault` is (round,
    position, error). Returns the command's signature and the rounds'
    sizes."""
    fr = _frontier()
    env = fr.build_env(seed, n_nodes=8)
    method = getattr(fr, method_name)(env)
    sizes = []
    real = env.provisioner.solver.solve_many

    def counted(kind, batch, *args, **kwargs):
        batch = list(batch)
        sizes.append(len(batch))
        return real(kind, batch, *args, **kwargs)

    env.provisioner.solver.solve_many = counted
    if fault is not None:
        _inject(env.provisioner.solver, *fault)
    cmd = method.compute_command(fr.budgets_for(env, method), *fr.candidates_for(env, method))
    return fr.command_signature(cmd), sizes


@pytest.mark.parametrize("method_name,seed", [("multi_method", 80), ("single_method", 50)])
def test_speculative_probe_kernel_error_fails_the_compute(monkeypatch, method_name, seed):
    """A probe the walk never reaches: a solver error there leaves the
    command as it was (the reference's sequential semantics, kept), a
    KernelError there fails the compute."""
    monkeypatch.setattr(_frontier().ffd, "DEVICE_MIN_PODS", 1)
    with tw.leg(T):
        clean, sizes = _compute(method_name, seed)
    assert sizes and sizes[0] >= 2, sizes
    speculative = []
    for pos in range(sizes[0]):
        with tw.leg(T):
            try:
                got, _ = _compute(method_name, seed, (0, pos, RuntimeError("shed")))
            except RuntimeError:
                continue  # the walk reached it
        if got == clean:
            speculative.append(pos)
    assert speculative, "every probe of the first round was walked"
    for pos in speculative:
        with tw.leg(T), pytest.raises(_kernel_error(), match="bogus"):
            _compute(method_name, seed, (0, pos, _kernel_error()("bogus pointer")))


def test_kernel_error_crosses_the_socket_typed():
    """_error_from maps the reply's KernelError to the class; a daemon whose
    engine build raises one answers the client's solve and solve_many with
    it."""
    from karpenter_tpu_torch.solverd.transport import SocketClient
    from karpenter_tpu_torch.utils.clock import Clock

    sd = _sd()
    KernelError = _kernel_error()
    err = SocketClient._error_from({"type": "KernelError", "message": "kt_cube: cudaError 700"})
    assert type(err) is KernelError and str(err) == "kt_cube: cudaError 700"
    rejected = SocketClient._error_from({"type": "QueueFullError", "message": "full"})
    assert type(rejected) is sd.QueueFullError
    other = SocketClient._error_from({"type": "ValueError", "message": "x"})
    assert type(other) is sd.TransportError

    def failing(catalog):
        raise KernelError("kt_row_compat: cudaError 700")

    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(svc, address="127.0.0.1:0", engine_factory=failing).start()
    client = SocketClient(daemon.address)
    fr = _frontier()
    try:
        with tw.leg(T):
            env = fr.build_env(81, n_nodes=4)
            plan = fr.FrontierSimulator(env.store, env.cluster, env.provisioner).plan(
                fr.candidates_for(env, fr.multi_method(env))[:2]
            )
            with pytest.raises(KernelError, match="cudaError 700"):
                client.solve(sd.KIND_SIMULATE, plan.scheduler, plan.pods, timeout=60.0)
            with pytest.raises(KernelError, match="cudaError 700"):
                client.solve_many(
                    sd.KIND_SIMULATE, [(plan.scheduler, plan.pods)], timeout=60.0, group="g"
                )
    finally:
        client.close()
        daemon.stop()
        svc.close()


def _consolidating_env():
    """Three half-full nodes the multi-node method folds into one."""
    fr = _frontier()
    env = fr.Env()
    pool = fr.nodepool("default")
    pool.spec.disruption.budgets = [fr.Budget(nodes="100%")]
    env.store.create(pool)
    for i in range(3):
        pods = [fr.unschedulable_pod(name=f"r{i}-p{j}", requests={"cpu": "1"}) for j in range(2)]
        env.add_pair(
            f"rep-{i}", pods=pods, instance_type="c-4x-amd64-linux",
            capacity={"cpu": "4", "memory": "8Gi", "pods": "110"},
        )
    env.informer.flush()
    env.clock.step(120)
    return env


def _raising(err):
    def solve_many(*args, **kwargs):
        raise err

    return solve_many


def test_reconcile_parks_a_command_without_faults():
    """The env the fault cases use consolidates when nothing fails."""
    with tw.leg(T):
        env = _consolidating_env()
        assert env.controller.reconcile() is True
        assert env.controller._pending is not None


@pytest.mark.parametrize("where", ["raised", "a probe's"])
def test_reconcile_raises_kernel_error_in_process(where):
    KernelError = _kernel_error()
    with tw.leg(T):
        env = _consolidating_env()
        solver = env.provisioner.solver
        if where == "raised":
            solver.solve_many = _raising(KernelError("kt_cube: cudaError 700"))
        else:
            _inject(solver, 0, 0, KernelError("kt_cube: cudaError 700"))
        before = env.controller._next_run
        with pytest.raises(KernelError, match="cudaError 700"):
            env.controller.reconcile()
        assert env.controller._next_run == before and env.controller._pending is None


@pytest.mark.parametrize("error", ["SolverRejection", "QueueFullError", "TransportError"])
def test_reconcile_backs_off_on_a_shed(error):
    """The reference's behaviour, kept: a shed defers the pass for one
    polling period."""
    from karpenter_tpu_torch.controllers.disruption.controller import POLLING_PERIOD

    sd = _sd()
    with tw.leg(T):
        env = _consolidating_env()
        env.provisioner.solver.solve_many = _raising(getattr(sd, error)("shed"))
        assert env.controller.reconcile() is False
        assert env.controller._pending is None
        assert env.controller._next_run == env.clock.now() + POLLING_PERIOD


def test_reconcile_raises_kernel_error_through_the_sidecar():
    """The sidecar's device fault reaches reconcile() over the socket as a
    KernelError; before the transport typed it, it was a TransportError
    and the controller backed off."""
    from karpenter_tpu_torch.solverd.transport import SocketClient
    from karpenter_tpu_torch.utils.clock import Clock

    sd = _sd()
    KernelError = _kernel_error()

    def failing(catalog):
        raise KernelError("kt_cube: cudaError 700")

    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(svc, address="127.0.0.1:0", engine_factory=failing).start()
    client = SocketClient(daemon.address)
    try:
        with tw.leg(T):
            env = _consolidating_env()
            env.provisioner.solver = client
            with pytest.raises(KernelError, match="cudaError 700"):
                env.controller.reconcile()
            assert env.controller._pending is None
    finally:
        client.close()
        daemon.stop()
        svc.close()
