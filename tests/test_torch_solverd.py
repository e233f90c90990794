"""The solver service (solverd) in the port against the JAX package's.

Every case of tests/test_solverd.py runs on both packages with its own
assertions (tests/torch_twins.py), and what the two runs decide must be
equal. Beside them:

- one numpy-seeded scenario decided four ways — the reference in-process,
  the port in-process, the port over a unix socket and the port over TCP
  loopback — must be decided identically each time, the port's routes on
  its device path (a device="cpu" engine: the kernels' plain versions);
- the port's two designed differences from the reference: a KernelError in
  a coalesced batch's primed sweep fails the batch's requests (the
  reference's priming swallows it), and a daemon whose engine build fails
  returns that error (the reference's daemon solves on the host instead);
- `python -m karpenter_tpu_torch.solverd` starts with the AOT flags, and as a
  subprocess on the CPU serves a solve equal to the in-process one, then
  drains and exits 0 on SIGTERM;
- neither the solve frame nor the daemon's reply carries a torch.Tensor.
"""

from __future__ import annotations

import io
import os
import pickle
import json
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_twins as tw  # noqa: E402
from torch_topo_cases import api  # noqa: E402

J, T = tw.J, tw.T
REPO = os.path.dirname(tw.TESTS)

torch.set_num_threads(1)


@pytest.mark.parametrize("case", tw.cases("test_solverd"))
def test_solverd_case_on_both_packages(case):
    tw.twin("test_solverd", case)


# -- one scenario, four routes ---------------------------------------------------


def seeded_scheduler(pkg: str, seed: int, engine=None, n_pods: int = 40):
    """tests/test_solverd.py's scenario with pods drawn by numpy: requests,
    and for some a zone or arch selector. The same seed builds the same
    scenario in either package."""
    a = api(pkg)
    m = a.m
    clock = m("utils.clock").FakeClock()
    store = m("runtime.store").Store(clock=clock)
    cluster = m("state.cluster").Cluster(clock, store, cloud_provider=None)
    informer = m("state.informer").StateInformer(store, cluster)
    recorder = m("events.recorder").Recorder(clock=clock)
    pool = a.nodepool("default")
    store.create(pool)
    informer.flush()
    rng = np.random.RandomState(seed)
    cpus = ["100m", "250m", "500m", "1", "2", "4"]
    mems = ["128Mi", "512Mi", "1Gi", "2Gi", "4Gi", "8Gi"]
    selectors = [{}, {}, {a.wk.LABEL_TOPOLOGY_ZONE: "kwok-zone-2"}, {a.wk.LABEL_ARCH: "arm64"}]
    pods = []
    for i in range(n_pods):
        p = a.unschedulable_pod(
            name=f"pod-{i:03d}",
            requests={"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]},
            node_selector=dict(selectors[rng.randint(len(selectors))]),
        )
        p.metadata.uid = f"uid-{i:03d}"
        p.metadata.creation_timestamp = 1000.0 + i
        store.create(p)
        pods.append(p)
    informer.flush()
    instance_types = {"default": list(a.CATALOG)}
    topology = m("scheduler.topology").Topology(store, cluster, [], [pool], instance_types, pods)
    scheduler = m("scheduler.scheduler").Scheduler(
        store, [pool], cluster, [], topology, instance_types, [], recorder, clock,
        engine=engine,
    )
    return scheduler, pods


def _engine(pkg):
    catalog = api(pkg).CATALOG
    if pkg == T:
        return api(pkg).m("ops.catalog").CatalogEngine(catalog, device="cpu")
    return api(pkg).m("ops.catalog").CatalogEngine(catalog)


def _inprocess(pkg, seed, n_pods=40):
    sd = api(pkg).m("solverd")
    clock = api(pkg).m("utils.clock").FakeClock()
    client = sd.InProcessClient(sd.SolverService(clock=clock))
    try:
        return client.solve(
            sd.KIND_SOLVE, *seeded_scheduler(pkg, seed, _engine(pkg), n_pods=n_pods), timeout=60.0
        )
    finally:
        client.close()


def _over_socket(seed, address):
    from karpenter_tpu_torch import solverd as sd
    from karpenter_tpu_torch.solverd.transport import _default_engine_factory
    from karpenter_tpu_torch.utils.clock import Clock

    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(
        svc, address=address, engine_factory=_default_engine_factory(device="cpu")
    ).start()
    client = sd.SocketClient(daemon.address)
    try:
        got = client.solve(sd.KIND_SOLVE, *seeded_scheduler(T, seed, _engine(T)), timeout=60.0)
        stats = client.stats()
    finally:
        client.close()
        daemon.stop()
        svc.close()
    return got, stats


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_four_routes_decide_alike(monkeypatch, tmp_path, seed):
    jffd, tffd = api(J).ffd, api(T).ffd
    monkeypatch.setattr(jffd, "DEVICE_MIN_PODS", 1)
    monkeypatch.setattr(jffd, "STRICT", True)
    monkeypatch.setattr(tffd, "DEVICE_MIN_PODS", 1)
    routes = {}
    with tw.leg(J):
        routes["reference in-process"] = tw.decisions(_inprocess(J, seed))
    solves0, fallbacks0 = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
    with tw.leg(T):
        routes["port in-process"] = tw.decisions(_inprocess(T, seed))
    with tw.leg(T):
        got, unix_stats = _over_socket(seed, str(tmp_path / "solverd.sock"))
        routes["port unix socket"] = tw.decisions(got)
    with tw.leg(T):
        got, tcp_stats = _over_socket(seed, "127.0.0.1:0")
        routes["port tcp"] = tw.decisions(got)
    want = routes["reference in-process"]
    assert want[0], "the scenario opens claims"
    for route, got in routes.items():
        assert got == want, route
    # each port route solved on its engine, none on the host loop (the
    # daemons' stats read this process's counters)
    assert tffd.DEVICE_SOLVES == solves0 + 3
    assert tffd.DEVICE_FALLBACKS == fallbacks0
    assert unix_stats["device_solves"] == solves0 + 2 == tcp_stats["device_solves"] - 1


# -- the designed differences ------------------------------------------------------


def _coalesced_batch(pkg, engine, fault):
    """Two requests on one engine, admitted before one drain; the engine's
    next sweep (the batch's primed one) raises `fault`."""
    sd = api(pkg).m("solverd")
    svc = sd.SolverService(clock=api(pkg).m("utils.clock").FakeClock())
    requests = [
        sd.SolveRequest(sd.KIND_SOLVE, *seeded_scheduler(pkg, 3, engine), timeout=60.0),
        sd.SolveRequest(
            sd.KIND_SIMULATE, *seeded_scheduler(pkg, 4, engine, n_pods=30), timeout=60.0),
    ]
    calls = _failing_first_sweep(engine, fault)
    return svc, [svc.submit(r) for r in requests], calls


def _failing_first_sweep(engine, error):
    """A stand-in `engine.feasibility` whose first call — the batch's primed
    sweep — raises `error`; later calls run the engine's own."""
    real = engine.feasibility
    calls = []

    def feasibility(*args, **kwargs):
        calls.append(len(calls))
        if len(calls) == 1:
            raise error
        return real(*args, **kwargs)

    engine.feasibility = feasibility
    return calls


def test_kernel_error_in_primed_sweep_fails_the_batch(monkeypatch):
    """Port: a device fault in the coalesced sweep fails both requests with
    KernelError; no request is solved, nothing falls back, and the masks
    the sweep was to make are not computed on the host. The reference's
    priming swallows the same error ("priming is an optimization") and
    solves both requests, on masks its solves then make themselves."""
    from karpenter_tpu_torch.device import KernelError

    fault = KernelError("cube: CUDA launch failed with cudaError 719")
    jffd, tffd = api(J).ffd, api(T).ffd
    monkeypatch.setattr(jffd, "DEVICE_MIN_PODS", 1)
    monkeypatch.setattr(tffd, "DEVICE_MIN_PODS", 1)

    with tw.leg(J):
        svc, entries, _ = _coalesced_batch(J, _engine(J), fault)
        assert svc.run_pending() == 2
        assert [e.error for e in entries] == [None, None]
        ref = [tw.decisions(e.result) for e in entries]
    solo = []
    for seed, n_pods in ((3, 40), (4, 30)):
        with tw.leg(J):
            scheduler, pods = seeded_scheduler(J, seed, _engine(J), n_pods=n_pods)
            solo.append(tw.decisions(scheduler.solve(pods, timeout=60.0)))
    assert ref[0][0] and ref == solo

    scheduler_cls = api(T).m("scheduler.scheduler").Scheduler
    solved = []
    monkeypatch.setattr(scheduler_cls, "solve", lambda self, *a, **k: solved.append(self))
    counters = (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS, tffd.JOINT_SWEEPS)
    with tw.leg(T):
        engine = _engine(T)
        svc, entries, calls = _coalesced_batch(T, engine, fault)
        with pytest.raises(KernelError):
            svc.run_pending()
    assert [type(e.error) for e in entries] == [KernelError, KernelError]
    assert all(e.done and e.result is None for e in entries)
    assert calls == [0], "one sweep, and no host or device sweep after it"
    assert solved == [], "no request of the batch was solved"
    assert (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS, tffd.JOINT_SWEEPS) == counters
    # the reserved placeholders stayed: nothing computed them on the host
    assert engine.solver_joint_cache and all(v is None for v in engine.solver_joint_cache.values())


def test_daemon_engine_build_failure_is_the_reply(monkeypatch):
    """Port: a daemon whose engine factory raises answers with that error,
    its type named, and solves nothing — here the real factory asked for
    the card on a machine without one. The reference's daemon drops the
    engine and answers from its host loop."""
    from karpenter_tpu_torch import solverd as sd
    from karpenter_tpu_torch.solverd.transport import _default_engine_factory
    from karpenter_tpu_torch.utils.clock import Clock

    if torch.cuda.is_available():
        pytest.skip("the card is here: the default factory builds its engine")
    scheduler_cls = api(T).m("scheduler.scheduler").Scheduler
    solved = []
    real_solve = scheduler_cls.solve
    monkeypatch.setattr(
        scheduler_cls, "solve",
        lambda self, *a, **k: solved.append(self) or real_solve(self, *a, **k),
    )
    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(svc, address="127.0.0.1:0",
                             engine_factory=_default_engine_factory()).start()
    client = sd.SocketClient(daemon.address)
    fallbacks = api(T).ffd.DEVICE_FALLBACKS
    try:
        with tw.leg(T), pytest.raises(sd.TransportError) as info:
            client.solve(sd.KIND_SOLVE, *seeded_scheduler(T, 5, _engine(T)), timeout=60.0)
        stats = svc.stats()
    finally:
        client.close()
        daemon.stop()
        svc.close()
    assert "daemon error RuntimeError: CUDA is not available" in str(info.value)
    assert solved == [] and stats["requests"] == 0 and stats["executed"] == 0
    assert api(T).ffd.DEVICE_FALLBACKS == fallbacks

    # the reference: the same failing factory, a host-loop answer
    jsd = api(J).m("solverd")

    def failing(catalog):
        raise RuntimeError("CUDA is not available")

    svc = jsd.SolverService(clock=api(J).m("utils.clock").Clock())
    daemon = jsd.SolverDaemon(svc, address="127.0.0.1:0", engine_factory=failing).start()
    client = jsd.SocketClient(daemon.address)
    try:
        with tw.leg(J):
            got = client.solve(jsd.KIND_SOLVE, *seeded_scheduler(J, 5, _engine(J)), timeout=60.0)
    finally:
        client.close()
        daemon.stop()
        svc.close()
    with tw.leg(J):
        host = seeded_scheduler(J, 5)
        assert tw.decisions(got) == tw.decisions(host[0].solve(host[1], timeout=60.0))


# -- the daemon as a process ---------------------------------------------------------


def _solverd(*args, **kwargs):
    return subprocess.Popen(
        [sys.executable, "-m", "karpenter_tpu_torch.solverd", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, **kwargs,
    )


@pytest.mark.parametrize("flag", [["--aot-ladder", "default"], ["--compile-cache-dir", None]])
def test_main_refuses_aot_flags(flag, tmp_path):
    """The AOT flags start the daemon (they exited 2 before the port had its
    AOT compiler): it listens with the compile service on, and drains and
    exits 0 on SIGTERM."""
    flag = [str(tmp_path / "cache") if f is None else f for f in flag]
    address = str(tmp_path / "s.sock")
    proc = _solverd("--device", "cpu", "--listen", address, *flag)
    deadline = time.monotonic() + 60.0
    try:
        while not os.path.exists(address):
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "daemon did not bind"
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    listening = [json.loads(line) for line in out.splitlines() if "solver daemon listening" in line]
    assert listening and listening[0]["aot"] is True, out


def test_main_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("the card is here")
    proc = _solverd("--listen", "127.0.0.1:0")
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 2 and "CUDA is not available" in out, out


def test_daemon_process_serves_and_drains(tmp_path):
    """`python -m karpenter_tpu_torch.solverd --device cpu --listen <path>`
    answers one solve as the in-process service does, then drains and exits
    0 on SIGTERM — all within 60 s."""
    from karpenter_tpu_torch import solverd as sd

    deadline = time.monotonic() + 60.0
    n_pods = 2 * api(T).ffd.DEVICE_MIN_PODS  # the daemon's threshold is its own
    with tw.leg(T):
        want = tw.decisions(_inprocess(T, 6, n_pods))
    address = str(tmp_path / "s.sock")
    proc = _solverd("--device", "cpu", "--listen", address, "--coalesce-window", "0")
    try:
        while not os.path.exists(address):
            assert proc.poll() is None, proc.communicate()[0]
            assert time.monotonic() < deadline, "daemon did not bind"
            time.sleep(0.05)
        client = sd.SocketClient(address)
        try:
            with tw.leg(T):
                got = client.solve(
                    sd.KIND_SOLVE, *seeded_scheduler(T, 6, _engine(T), n_pods=n_pods), timeout=60.0
                )
            stats = client.stats()
        finally:
            client.close()
        assert tw.decisions(got) == want
        assert stats["device_solves"] >= 1 and stats["device_fallbacks"] == 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "drained" in out
    assert not os.path.exists(address)


# -- no device state on the wire -------------------------------------------------------


class _TensorFlagger(pickle.Pickler):
    """Pickles as usual and lists every torch.Tensor it meets."""

    def __init__(self, file):
        super().__init__(file)
        self.tensors = []

    def persistent_id(self, obj):
        if isinstance(obj, torch.Tensor):
            self.tensors.append(tuple(obj.shape))
        return None


def _tensors_in(obj) -> list:
    flagger = _TensorFlagger(io.BytesIO())
    flagger.dump(obj)
    return flagger.tensors


def test_wire_carries_no_tensor(monkeypatch):
    """The frame SocketClient.encode builds and the daemon's reply hold no
    torch.Tensor: the engine stays behind on both sides, and so does every
    other device buffer (transport.py's trust-model docstring)."""
    from karpenter_tpu_torch import solverd as sd
    from karpenter_tpu_torch.solverd import transport
    from karpenter_tpu_torch.solverd.transport import _default_engine_factory
    from karpenter_tpu_torch.utils.clock import Clock

    monkeypatch.setattr(api(T).ffd, "DEVICE_MIN_PODS", 1)
    engine = _engine(T)
    # the engine does hold tensors: the flagger sees them
    assert _tensors_in(engine)
    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(
        svc, address="127.0.0.1:0", engine_factory=_default_engine_factory(device="cpu")
    )
    client = sd.SocketClient(daemon.address)
    try:
        with tw.leg(T):
            scheduler, pods = seeded_scheduler(T, 7, engine)
            scheduler.solve(pods, timeout=60.0)  # leaves its solve state behind
            scheduler, pods = seeded_scheduler(T, 7, engine)
            frame = client.encode(sd.KIND_SOLVE, scheduler, pods, 60.0)
            assert scheduler.engine is engine, "the engine is put back after encoding"
            body = transport._unpack(frame["payload"])
            assert body["catalog"] and _tensors_in(body) == []
            reply = daemon._process(frame)
        assert reply["ok"], reply
        results = transport._unpack(reply["payload"])
        assert results.new_node_claims
        assert _tensors_in(results) == []
        assert all(nc.engine is None for nc in results.new_node_claims)
    finally:
        client.close()
        daemon.stop()
        svc.close()
