"""The port's delta solves (ops/delta.py, the scan variants of ops/packer.py,
the delta branch of ops/fused.py) against the JAX package's.

1. Plain B15/B16: the JAX `solve_scan_full_fn` and `solve_scan_resume_fn`
   and the port's `solve_scan_full` / `solve_scan_resume` on CPU tensors
   (the plain loop) on the same numpy-seeded operands; all 23 state
   components compared as raw bytes, the port's resume started from the JAX
   state through `convert.scan_state_from_numpy`.
2. The cases of tests/test_delta.py (encode cache, group-delta fuzz, scan
   residency, invalidation pathologies; the solver daemon is not ported),
   run on the port, and for the scan residency beside the reference: the
   sequence of outcomes (cold, warm, miss reasons) and the decisions of
   each pass must equal the reference's on the same pod sequence.

The JAX scan runs on the CPU under real float64: `packer.scan_x64` is
monkeypatched to `jax.enable_x64(True)` in each test, as
tests/test_torch_scan.py explains (nothing in karpenter_tpu/ changes).
Every comparison is exact.
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import os
import sys

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
from karpenter_tpu_torch import convert  # noqa: E402
from karpenter_tpu_torch.ops import delta  # noqa: E402
from karpenter_tpu_torch.ops import ffd as tffd  # noqa: E402
from karpenter_tpu_torch.ops import fused as tfused  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim  # noqa: E402
from test_torch_group import build_shapes, churn_batch, engine_for  # noqa: E402
from torch_inputs import SCAN_EDGE_CASES, scan_edge_inputs, scan_inputs  # noqa: E402

torch.set_num_threads(1)

JAX, PORT = "karpenter_tpu", "karpenter_tpu_torch"


@contextlib.contextmanager
def _x64():
    with jax.enable_x64(True):
        yield


def _m(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _assert_state_equal(got: tuple, want: tuple) -> None:
    """23 numpy components, raw bytes and dtypes."""
    assert len(got) == len(want) == jpacker.SCAN_N_STATE
    for k, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


# -- B15 / B16 operand for operand ------------------------------------------------

VARIANTS = ["plain", "nodes", "limits", "both"]


def _prefix_args(args: tuple, p_lo: int) -> tuple:
    """The operands of a pass that saw only the first p_lo pods: the pod
    stream padded with -1 past them, n_pods = p_lo."""
    pod_gi = np.array(args[0], copy=True)
    pod_gi[p_lo:] = -1
    return (pod_gi,) + args[1:13] + (np.int32(p_lo),) + args[14:]


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("seed", range(3))
def test_scan_full_and_resume_plain_match_jax(monkeypatch, variant, seed):
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    cfg, args = scan_inputs(seed, variant in ("nodes", "both"), variant in ("limits", "both"))
    n_pods = int(args[13])
    p_lo = n_pods * 2 // 3
    pre = _prefix_args(args, p_lo)
    with jpacker.scan_x64():
        want_full = tuple(np.asarray(a) for a in jpacker.solve_scan_full_fn(*cfg)(*args))
        want_pre = tuple(np.asarray(a) for a in jpacker.solve_scan_full_fn(*cfg)(*pre))
        want_res = tuple(np.asarray(a) for a in jpacker.solve_scan_resume_fn(*cfg)(
            *args, *(jnp.asarray(a) for a in want_pre), np.int32(p_lo)))
    n0 = dict(tpacker.LAUNCHES)
    ops = convert.scan_operands_from_numpy(args, "cpu")
    full = tpacker.solve_scan_full(cfg, ops)
    assert len(full) == len(tpacker.SCAN_STATE_FIELDS) + 1
    _assert_state_equal(convert.scan_state_to_numpy(full[:-1]), want_full)
    assert int(full[-1]) == int(full[0][7]) >= int((want_full[11] >= 0).sum())
    # the classic solve is the full solve's decode subset
    classic = tpacker.solve_scan(cfg, ops)
    for g, i in zip(classic[:-1], tpacker._SCAN_OUT_IDX):
        assert np.asarray(g).tobytes() == want_full[i].tobytes()
    # resume from the JAX prefix state, written in place
    state = convert.scan_state_from_numpy(want_pre, "cpu")
    res = tpacker.solve_scan_resume(cfg, ops, state, p_lo)
    assert all(a is b for a, b in zip(res[:-1], state))
    _assert_state_equal(convert.scan_state_to_numpy(res[:-1]), want_res)
    assert tpacker.LAUNCHES == n0  # the plain versions launch nothing
    # a prefix that drained with no requeue resumes into the cold solve of
    # the whole list: the property the residency rests on
    head, tail, stop, abort = (int(want_pre[k]) for k in range(4))
    if abort == 0 and not stop and head == tail == p_lo:
        _assert_state_equal(convert.scan_state_to_numpy(res[:-1]), want_full)
        assert int(res[-1]) == n_pods - p_lo or int(want_full[1]) > n_pods


@pytest.mark.parametrize("case", SCAN_EDGE_CASES)
def test_scan_edges_plain_match_jax(monkeypatch, case):
    """The edges the card tests hold the kernel's designs to
    (tests/torch_inputs.py scan_edge_inputs): the plain full solve, or for
    queue_overflow the plain resume from the JAX prefix state with head and
    tail moved to Qcap - 4, equals the JAX program's, and the edge is
    really reached."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    cfg, args, p_lo = scan_edge_inputs(case)
    n_pods = int(args[13])
    ops = convert.scan_operands_from_numpy(args, "cpu")
    if p_lo is None:
        with jpacker.scan_x64():
            want = tuple(np.asarray(a) for a in jpacker.solve_scan_full_fn(*cfg)(*args))
        got = tpacker.solve_scan_full(cfg, ops)
    else:
        with jpacker.scan_x64():
            pre = [np.asarray(a) for a in jpacker.solve_scan_full_fn(*cfg)(*_prefix_args(args, p_lo))]
            assert int(pre[0]) == int(pre[1]) == p_lo  # the prefix drained
            pre[0] = pre[1] = np.int32(pre[7].shape[0] - (n_pods - p_lo) - 1)  # head = tail = Qcap - 4
            want = tuple(np.asarray(a) for a in jpacker.solve_scan_resume_fn(*cfg)(
                *args, *(jnp.asarray(a) for a in pre), np.int32(p_lo)))
        got = tpacker.solve_scan_resume(cfg, ops, convert.scan_state_from_numpy(pre, "cpu"), p_lo)
    _assert_state_equal(convert.scan_state_to_numpy(got[:-1]), want)
    head, tail, stop, abort, steps = (int(got[0][k]) for k in (0, 1, 2, 3, 7))
    if case == "requeue_last":  # one requeue at head + 1 == tail, then the cycle stop
        assert (head, tail, stop, abort, steps) == (n_pods, n_pods + 1, 1, 0, n_pods + 1)
    elif case == "cycle_stop":
        assert stop == 1 and abort == 0 and tail > n_pods + 1
    elif case == "claim_overflow":
        assert abort == tpacker.SCAN_CLAIM_OVERFLOW
    elif case == "keys_max":  # every pod of group 1 opened a claim of its own
        n1 = int((args[0][:n_pods] == 1).sum())
        assert n1 > 1 and abort == 0 and int(got[0][6]) >= n1
    else:  # one requeue into the last slot, then the queue is full
        assert abort == tpacker.SCAN_QUEUE_OVERFLOW and tail == want[7].shape[0] and steps == 2


def test_scan_state_round_trip():
    cfg, args = scan_inputs(1, True, True)
    ops = convert.scan_operands_from_numpy(args, "cpu")
    full = tpacker.solve_scan_full(cfg, ops)[:-1]
    ref = convert.scan_state_to_numpy(full)
    assert ref[2].dtype == np.bool_ and ref[0].shape == ()
    back = convert.scan_state_from_numpy(ref, "cpu")
    for a, b in zip(back[1:], full[1:]):
        assert torch.equal(a, b)
    assert torch.equal(back[0][:7], full[0][:7]) and int(back[0][7]) == 0
    with pytest.raises(ValueError):
        convert.scan_state_from_numpy(ref[:-1], "cpu")


# -- the scheduler in either package, with a persistent engine ---------------------


class PkgEnv:
    """One package's scheduling environment around ONE engine (residencies
    live on the engine): tests/test_scheduler.py's Env, in either
    package's API. The port's engine runs device="cpu"."""

    def __init__(self, pkg: str, catalog=None):
        self.pkg = pkg
        core = _m(pkg, "apis.core")
        self.clock = _m(pkg, "utils.clock").FakeClock()
        self.store = _m(pkg, "runtime.store").Store(clock=self.clock)
        self.cluster = _m(pkg, "state.cluster").Cluster(self.clock, self.store, cloud_provider=None)
        pool = _m(pkg, "apis.nodepool").NodePool(metadata=core.ObjectMeta(name="default"))
        pool.set_condition("Ready", "True")
        self.store.create(pool)
        self.pools = [pool]
        catalog = catalog or _m(pkg, "cloudprovider.kwok.instance_types").construct_instance_types()
        self.its = {"default": catalog}
        kw = {"device": "cpu"} if pkg == PORT else {}
        self.engine = _m(pkg, "ops.catalog").CatalogEngine(catalog, **kw)

    def schedule(self, pods):
        state_nodes = self.cluster.state_nodes()
        topology = _m(self.pkg, "scheduler.topology").Topology(
            self.store, self.cluster, state_nodes, self.pools, self.its, pods
        )
        scheduler = _m(self.pkg, "scheduler.scheduler").Scheduler(
            self.store, self.pools, self.cluster, state_nodes, topology, self.its, [],
            _m(self.pkg, "events.recorder").Recorder(clock=self.clock), self.clock,
            engine=self.engine,
        )
        return scheduler.solve(pods)

    @property
    def delta(self):
        return jdelta if self.pkg == JAX else delta

    @property
    def residency(self):
        return self.delta.scan_residency(self.engine)


def plain_pods(pkg: str, n: int = 128, cpus=("250m", "500m", "1", "2"), prefix="fu", ts=0.0):
    """tests/test_fused.py's plain_pods in either package."""
    core = _m(pkg, "apis.core")
    res = _m(pkg, "utils.resources")
    pods = []
    for i in range(n):
        p = core.Pod(
            metadata=core.ObjectMeta(name=f"{prefix}-{i:05d}", uid=f"{prefix}-uid-{i:05d}"),
            spec=core.PodSpec(containers=[core.Container(
                requests=res.parse_resource_list({"cpu": cpus[i % len(cpus)], "memory": "512Mi"})
            )]),
        )
        p.metadata.creation_timestamp = ts
        p.status.conditions.append(core.Condition(type="PodScheduled", status="False", reason="Unschedulable"))
        pods.append(p)
    return pods


def canon(results):
    claims = sorted(
        (sorted(p.metadata.name for p in nc.pods), sorted(it.name for it in nc.instance_type_options))
        for nc in results.new_node_claims
    )
    return claims, sorted((p.metadata.name, str(e)) for p, e in results.pod_errors.items())


@pytest.fixture
def delta_fused(monkeypatch):
    """Both packages with the fused scan forced on, delta solves on (a
    self-check every 4 warm passes), the JAX scan in real float64, every
    residency dropped before and after, fresh name counters."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")
    monkeypatch.setattr(jfused, "FUSED_MODE", "on")
    monkeypatch.setattr(tfused, "FUSED_MODE", "on")
    for mod in (jnodeclaim, tnodeclaim):
        monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
    for mod in (jffd, tffd):
        monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))
    saved = [(mod, mod.DELTA_MODE, mod.RESOLVE_FULL_EVERY) for mod in (jdelta, delta)]
    for mod in (jdelta, delta):
        mod.configure(mode="on", resolve_full_every=4)
        mod.invalidate_all("test-setup")
    yield
    for mod, mode, every in saved:
        mod.configure(mode=mode, resolve_full_every=every)
        mod.invalidate_all("test-teardown")


def run_stream(pkg: str, passes, catalog_fn=None) -> list:
    """Solve each pass's pods (built by passes[k](pkg)) on one env; per
    pass: (scan outcome, decisions)."""
    env = PkgEnv(pkg, catalog_fn(pkg) if catalog_fn else None)
    out = []
    for make in passes:
        r = env.schedule(make(pkg))
        out.append((env.residency.last_outcome, canon(r)))
    return out


def _both(passes, catalog_fn=None):
    want = run_stream(JAX, passes, catalog_fn)
    got = run_stream(PORT, passes, catalog_fn)
    assert got == want
    return got


# -- TestScanResidency, beside the reference ----------------------------------------


def test_repeat_solve_warm_resumes_bit_identical(delta_fused):
    """The same batch re-solved back to back warm-resumes (empty suffix)
    with identical claims and zero errors, in both packages alike."""
    env = PkgEnv(PORT)
    r1 = env.schedule(plain_pods(PORT, 96, cpus=("1",)))
    assert not r1.pod_errors
    res = env.residency
    assert res.state is not None and res.extendable
    c0 = delta.delta_counters()
    r2 = env.schedule(plain_pods(PORT, 96, cpus=("1",)))
    assert not r2.pod_errors and canon(r1) == canon(r2)
    assert delta.delta_counters()["delta_scan_warm"] == c0["delta_scan_warm"] + 1
    assert res.last_outcome == "warm" and int(res.state[0][7]) == 0  # no suffix: no step
    got = _both([lambda pkg: plain_pods(pkg, 96, cpus=("1",))] * 2)
    assert [o for o, _ in got] == ["cold", "warm"]


def test_suffix_arrivals_extend_warm(delta_fused):
    """Uniform-shape arrivals extend the previous stream as an exact
    suffix — the shape-stable churn the warm path is built for."""
    got = _both([
        lambda pkg: plain_pods(pkg, 96, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 128, cpus=("1",)),
    ])
    assert [o for o, _ in got] == ["cold", "warm"]
    assert not got[1][1][1]


def test_mixed_size_arrival_misses_prefix_but_stays_correct(delta_fused):
    """A LARGER new pod sorts to the front of the FFD stream — the prefix
    contract breaks, the pass goes cold, and the decisions still match a
    delta-off solve."""
    got = _both([
        lambda pkg: plain_pods(pkg, 96, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 97, cpus=("4",)),
    ])
    assert got[1][0] in ("prefix", "operands", "rung")
    delta.configure(mode="off")
    env = PkgEnv(PORT)
    assert canon(env.schedule(plain_pods(PORT, 97, cpus=("4",)))) == got[1][1]


def test_outcome_sequence_matches_reference(delta_fused):
    """A longer stream through both packages: repeats, suffix arrivals,
    a prefix break, a shape change (operands), and the periodic self-check
    (every 4th warm pass) — the same outcome on every pass, the same
    decisions, and the self-check counters move alike."""
    passes = [
        lambda pkg: plain_pods(pkg, 64, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 80, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 80, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 90, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 100, cpus=("1",)),
        lambda pkg: plain_pods(pkg, 100, cpus=("500m", "1")),
        lambda pkg: plain_pods(pkg, 100, cpus=("500m", "1")) + plain_pods(pkg, 3, cpus=("2",), prefix="big"),
        lambda pkg: plain_pods(pkg, 100, cpus=("500m", "1")) + plain_pods(pkg, 3, cpus=("2",), prefix="big"),
    ]
    c0 = {mod: mod.delta_counters() for mod in (jdelta, delta)}
    got = _both(passes)
    outcomes = [o for o, _ in got]
    assert outcomes[:5] == ["cold", "warm", "warm", "warm", "warm"], outcomes
    assert "warm" in outcomes[5:] and set(outcomes[5:]) - {"warm"}, outcomes
    moved = {
        mod: {k: v - c0[mod].get(k, 0) for k, v in mod.delta_counters().items()
              if k.startswith(("delta_scan", "delta_selfchecks", "delta_passes"))}
        for mod in (jdelta, delta)
    }
    assert moved[jdelta] == moved[delta]
    assert moved[delta]["delta_selfchecks_identical"] >= 1
    assert moved[delta]["delta_selfchecks_divergent"] == 0


def _doubled_catalog(pkg: str) -> list:
    """The kwok catalog and a copy of every type under another name (same
    requirements, offerings and capacity): each copy shares its original's
    unique-allocatable row."""
    InstanceType = _m(pkg, "cloudprovider.types").InstanceType
    base = _m(pkg, "cloudprovider.kwok.instance_types").construct_instance_types()
    return base + [
        InstanceType(name=f"{it.name}-r1", requirements=it.requirements, offerings=it.offerings,
                     capacity=it.capacity, overhead=it.overhead)
        for it in base
    ]


def test_template_mask_change_with_same_famu_ok_resumes_warm(delta_fused):
    """The NodePool's instance types drop half of the copies between two
    passes: the template mask changes, famu_ok (the uid survival the scan
    consumes) does not, since every dropped copy's original stays. The
    reference fingerprints famu_ok and resumes; the port must too, not miss
    with `operands`."""
    seen = {}
    for pkg in (JAX, PORT):
        catalog = _doubled_catalog(pkg)
        env = PkgEnv(pkg, catalog)
        trace = []
        for pods, its in ((96, catalog), (128, [it for i, it in enumerate(catalog)
                                                if not (it.name.endswith("-r1") and i % 2)])):
            env.its = {"default": its}
            r = env.schedule(plain_pods(pkg, pods, cpus=("1",)))
            trace.append((env.residency.last_outcome, canon(r)))
        seen[pkg] = trace
    assert [t[0] for t in seen[JAX]] == ["cold", "warm"]
    assert seen[PORT] == seen[JAX]
    # the premise: the first pass's options hold copies the second drops
    dropped = {it.name for i, it in enumerate(_doubled_catalog(PORT)) if it.name.endswith("-r1") and i % 2}
    first, second = ({n for _, opts in seen[PORT][k][1][0] for n in opts} for k in (0, 1))
    assert first & dropped and not second & dropped


def test_scan_selfcheck_divergence_drops_residency(delta_fused):
    """Corrupt the resident scan state; the every-pass self-check fires the
    divergence event, falls back to the cold result, and drops the
    residency."""
    delta.configure(resolve_full_every=1)
    env = PkgEnv(PORT)
    r1 = env.schedule(plain_pods(PORT, 96, cpus=("1",)))
    res = env.residency
    assert res.state is not None
    # corrupt pod_node (reference component 10, a decode output)
    state = list(res.state)
    assert tpacker.scan_component(state, 10) is state[4]
    state[4] = state[4] + 7
    res.state = tuple(state)
    fired = []
    d0 = delta.delta_counters()["delta_selfchecks_divergent"]
    delta.on_divergence(lambda k, d: fired.append((k, d)), key="test")
    try:
        r2 = env.schedule(plain_pods(PORT, 96, cpus=("1",)))
    finally:
        delta.on_divergence(lambda k, d: None, key="test")
    assert not r2.pod_errors
    assert canon(r1) == canon(r2)
    assert fired and fired[0][0] == "packer.solve_scan"
    assert delta.delta_counters()["delta_selfchecks_divergent"] == d0 + 1
    assert res.last_outcome == "warm" and res.warm_passes == 0  # dropped, re-seeded cold


def test_small_batches_route_to_device_when_forced(delta_fused):
    """Below DEVICE_MIN_PODS, a forced fused+delta operator still takes the
    device path — and the decisions match the reference's."""
    d0 = tffd.DEVICE_SOLVES
    got = _both([lambda pkg: plain_pods(pkg, 8, cpus=("1",))])
    assert tffd.DEVICE_SOLVES == d0 + 1
    assert got[0][0] == "cold" and not got[0][1][1]


def test_small_batches_stay_on_host_without_delta(delta_fused):
    delta.configure(mode="off")
    d0 = tffd.DEVICE_SOLVES
    PkgEnv(PORT).schedule(plain_pods(PORT, 8, cpus=("1",)))
    assert tffd.DEVICE_SOLVES == d0


def test_delta_off_uses_the_classic_scan(delta_fused, monkeypatch):
    delta.configure(mode="off")
    calls = []
    real = tpacker.solve_scan_full
    monkeypatch.setattr(tpacker, "solve_scan_full", lambda *a: calls.append(1) or real(*a))
    env = PkgEnv(PORT)
    env.schedule(plain_pods(PORT, 96, cpus=("1",)))
    assert not calls and env.residency.state is None


# -- chip_smoke.py's suffix churn at 2,000 pods --------------------------------------

BENCH_ZONES = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]


def bench_shapes(pkg: str):
    """chip_smoke.py's bench shapes (RandomState(7), 200 shapes) and pod
    picks, in either package."""
    wk = _m(pkg, "apis.labels")
    parse = _m(pkg, "utils.resources").parse_resource_list
    rng = np.random.RandomState(7)
    cpus = ["100m", "250m", "500m", "1", "2", "4"]
    mems = ["128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    shapes = []
    for _ in range(200):
        sel = {}
        roll = rng.rand()
        if roll < 0.3:
            sel[wk.LABEL_ARCH] = ["amd64", "arm64"][rng.randint(2)]
        if roll < 0.15:
            sel[wk.LABEL_TOPOLOGY_ZONE] = BENCH_ZONES[rng.randint(4)]
        if roll > 0.8:
            sel[wk.CAPACITY_TYPE_LABEL_KEY] = wk.CAPACITY_TYPE_SPOT
        shapes.append((sel, parse({"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]})))
    return shapes, rng.randint(len(shapes), size=50_000)


def _pod(pkg, name, uid, sel, requests, ts):
    core = _m(pkg, "apis.core")
    pod = core.Pod(
        metadata=core.ObjectMeta(name=name, uid=uid),
        spec=core.PodSpec(node_selector=dict(sel), containers=[core.Container(requests=dict(requests))]),
    )
    pod.metadata.creation_timestamp = ts
    pod.status.conditions.append(core.Condition(type="PodScheduled", status="False", reason="Unschedulable"))
    return pod


def churn_stream(pkg: str, n: int, passes: int, per_pass: int) -> list:
    """The first n bench pods, then `passes` lists that each add per_pass
    pods of the last-sorting picked shape (least cpu, then least memory),
    with later creation timestamps and uids: exact FFD suffixes."""
    shapes, picks = bench_shapes(pkg)
    picks = picks[:n]
    base = [_pod(pkg, f"pod-{i:05d}", f"uid-{i:05d}", *shapes[s], float(i % 13)) for i, s in enumerate(picks)]
    wk = _m(pkg, "apis.labels")
    last = min(set(picks.tolist()), key=lambda s: (shapes[s][1][wk.RESOURCE_CPU], shapes[s][1][wk.RESOURCE_MEMORY], s))
    out, pods = [], list(base)
    for k in range(passes + 1):
        out.append(list(pods))
        pods = pods + [_pod(pkg, f"churn-{k:02d}-{j:03d}", f"uid-churn-{k:02d}-{j:03d}", *shapes[last],
                            100.0 + k) for j in range(per_pass)]
    return out


def test_suffix_churn_2000_pods_warm_resumes(delta_fused):
    """chip_smoke.py's delta phase at 2,000 pods on the kwok catalog: one
    cold pass, then two churn passes of 24 suffix pods each (2,048 pods
    fill the pod bucket; one more pass would move to the next rung). The
    reference warm-resumes every churn pass; the port's outcomes, steps
    and decisions equal the reference's, and the self-check (every 2nd
    warm pass here) agrees."""
    for mod in (jdelta, delta):
        mod.configure(resolve_full_every=2)
    c0 = delta.delta_counters()
    seen = {}
    for pkg in (JAX, PORT):
        env = PkgEnv(pkg)
        trace = []
        for pods in churn_stream(pkg, 2000, 2, 24):
            r = env.schedule(pods)
            steps = int(env.residency.state[0][7]) if pkg == PORT else None
            trace.append((env.residency.last_outcome, canon(r), steps))
        seen[pkg] = trace
    assert [t[0] for t in seen[JAX]] == ["cold", "warm", "warm"]
    assert [t[:2] for t in seen[PORT]] == [t[:2] for t in seen[JAX]]
    assert [t[2] for t in seen[PORT]][1:] == [24, 24]
    assert not seen[PORT][-1][1][1]  # no pod errors
    c1 = delta.delta_counters()
    assert c1["delta_selfchecks_identical"] == c0["delta_selfchecks_identical"] + 1
    assert c1["delta_selfchecks_divergent"] == c0["delta_selfchecks_divergent"]


# -- TestEncodeCache -------------------------------------------------------------------


@pytest.fixture
def delta_on():
    old_mode, old_every = delta.DELTA_MODE, delta.RESOLVE_FULL_EVERY
    delta.configure(mode="on", resolve_full_every=4)
    delta.invalidate_all("test-setup")
    yield
    delta.configure(mode=old_mode, resolve_full_every=old_every)
    delta.invalidate_all("test-teardown")


def _encode(engine, reqs, requests):
    return tpacker.encode_pods_for_packer(engine, reqs, requests)


def test_content_fingerprint_reuses_rebuilt_shapes(delta_on):
    """Pass 2 rebuilds every Requirements object (same values) — all shapes
    content-hit with ZERO bytes re-encoded; the encodes equal the
    reference's one-shot encode."""
    engine = engine_for(PORT)
    rng = np.random.RandomState(11)
    shapes1 = build_shapes(PORT)
    reqs1, requests = churn_batch(PORT, engine, rng, shapes1, 200)
    delta.configure(mode="off")
    cold = _encode(engine, reqs1, requests)
    delta.configure(mode="on")
    g1 = _encode(engine, reqs1, requests)
    cache = delta.encode_cache(engine)
    assert cache.last_pass_misses > 0 and cache.last_pass_bytes > 0
    shapes2 = build_shapes(PORT)
    id_of = {id(s): i for i, s in enumerate(shapes1)}
    g2 = _encode(engine, [shapes2[id_of[id(r)]] for r in reqs1], requests)
    assert cache.last_pass_misses == 0 and cache.last_pass_bytes == 0 and cache.last_pass_hits > 0
    jengine = engine_for(JAX)
    jshapes = build_shapes(JAX)
    jid = {id(s): i for i, s in enumerate(shapes1)}
    want = jpacker.encode_pods_for_packer(jengine, [jshapes[jid[id(r)]] for r in reqs1], requests)
    for name in ("membership", "requests_q", "key_present", "counts", "group_of_pod"):
        for g in (cold, g1, g2):
            np.testing.assert_array_equal(getattr(g, name), getattr(want, name))


def test_bytes_scale_with_churn_not_cluster(delta_on):
    engine = engine_for(PORT)
    rng = np.random.RandomState(12)
    shapes = build_shapes(PORT)
    reqs, requests = churn_batch(PORT, engine, rng, shapes, 100)
    _encode(engine, reqs, requests)
    cache = delta.encode_cache(engine)
    reqs2, requests2 = churn_batch(PORT, engine, rng, shapes, 200)
    _encode(engine, reqs2, requests2)
    assert cache.last_pass_bytes == 0
    rq = _m(PORT, "scheduling.requirements")
    wk = _m(PORT, "apis.labels")
    novel = rq.Requirements(rq.Requirement(wk.CAPACITY_TYPE_LABEL_KEY, rq.Operator.IN, ["spot"]))
    _encode(engine, list(reqs2) + [novel], np.vstack([requests2, requests2[-1:]]))
    assert cache.last_pass_misses == 1
    assert 0 < cache.last_pass_bytes < 10_000


def test_capacity_overflow_resets_and_meters(delta_on, monkeypatch):
    monkeypatch.setattr(delta.EncodeCache, "MAX_SHAPES", 4)
    engine = engine_for(PORT)
    cache = delta.encode_cache(engine)
    c0 = delta.delta_counters().get("delta_invalidations", 0)
    rq = _m(PORT, "scheduling.requirements")
    wk = _m(PORT, "apis.labels")
    cache.begin_pass()
    for i in range(8):
        cache.lookup(engine, rq.Requirements(rq.Requirement(wk.LABEL_TOPOLOGY_ZONE, rq.Operator.IN, [f"z-{i}"])),
                     engine.num_rows)
    cache.end_pass()
    assert len(cache._by_content) <= 4
    assert delta.delta_counters()["delta_invalidations"] > c0


# -- TestGroupDeltaFuzz ------------------------------------------------------------------


def _assert_same(got, full):
    for a, b in zip(got, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_churn_stream_bit_identical_to_full(delta_on):
    engine = engine_for(PORT)
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(21)
    res = delta.group_residency(solver)
    warm_seen = False
    for p in range(7):
        reqs, requests = churn_batch(PORT, engine, rng, build_shapes(PORT, 8 + (p % 3)), 60 + 20 * p)
        grouped = _encode(engine, reqs, requests)
        _assert_same(solver.solve(grouped), solver._solve_full(grouped))
        warm_seen = warm_seen or res.last_mode == "warm"
    assert warm_seen and res.warm_passes > 0


def test_count_only_churn_solves_zero_groups(delta_on):
    engine = engine_for(PORT)
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(22)
    reqs, requests = churn_batch(PORT, engine, rng, build_shapes(PORT), 120)
    solver.solve(_encode(engine, reqs, requests))
    c0 = delta.delta_counters()
    grouped2 = _encode(engine, reqs + reqs, np.vstack([requests, requests]))
    _assert_same(solver.solve(grouped2), solver._solve_full(grouped2))
    c1 = delta.delta_counters()
    assert c1["delta_groups_solved"] == c0["delta_groups_solved"]
    assert c1["delta_groups_reused"] > c0["delta_groups_reused"]


def test_generation_bump_invalidates(delta_on):
    engine = engine_for(PORT)
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(23)
    reqs, requests = churn_batch(PORT, engine, rng, build_shapes(PORT), 80)
    solver.solve(_encode(engine, reqs, requests))
    res = delta.group_residency(solver)
    assert res.core is not None
    gen0 = res.gen
    rq = _m(PORT, "scheduling.requirements")
    engine.rows_for(rq.Requirements(rq.Requirement("example.com/delta-novel-row", rq.Operator.EXISTS)))
    engine._ensure_rows()
    c0 = delta.delta_counters()["delta_invalidations"]
    got = solver.solve(_encode(engine, reqs, requests))
    _assert_same(got, solver._solve_full(_encode(engine, reqs, requests)))
    assert res.gen != gen0
    assert delta.delta_counters()["delta_invalidations"] > c0


def test_slot_capacity_overflow_resets(delta_on, monkeypatch):
    monkeypatch.setattr(delta, "MAX_GROUP_SLOTS", 4)
    engine = engine_for(PORT)
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(24)
    reqs, requests = churn_batch(PORT, engine, rng, build_shapes(PORT), 120)
    grouped = _encode(engine, reqs, requests)
    _assert_same(solver.solve(grouped), solver._solve_full(grouped))


def test_injected_divergence_fires_event_and_falls_back(delta_on):
    delta.configure(resolve_full_every=1)
    engine = engine_for(PORT)
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(25)
    reqs, requests = churn_batch(PORT, engine, rng, build_shapes(PORT), 100)
    grouped = _encode(engine, reqs, requests)
    solver.solve(grouped)
    res = delta.group_residency(solver)
    assert res.core is not None
    res.core[:, 0] = 7  # flip every resident choice to an absurd value
    d0 = delta.delta_counters()["delta_selfchecks_divergent"]
    fired = []
    delta.on_divergence(lambda k, d: fired.append((k, d)), key="test")
    try:
        got = solver.solve(grouped)
    finally:
        delta.on_divergence(lambda k, d: None, key="test")
    _assert_same(got, solver._solve_full(grouped))
    assert fired and fired[0][0] == "packer.solve_block"
    assert res.core is None
    assert delta.delta_counters()["delta_selfchecks_divergent"] == d0 + 1


# -- TestInvalidationPathologies ------------------------------------------------------------


def _seed_residencies():
    engine = engine_for(PORT)
    solver = tpacker.GroupSolver(engine)
    rng = np.random.RandomState(31)
    reqs, requests = churn_batch(PORT, engine, rng, build_shapes(PORT), 80)
    solver.solve(_encode(engine, reqs, requests))
    delta.scan_residency(engine).state = (torch.zeros(8, dtype=torch.int32),)  # a stand-in state
    return engine, solver


def test_invalidate_all_drops_everything(delta_on):
    engine, solver = _seed_residencies()
    cache = delta.encode_cache(engine)
    assert cache.stats()["shapes_cached"] > 0
    delta.invalidate_all("test-pathology")
    assert delta.group_residency(solver).core is None
    assert delta.scan_residency(engine).state is None
    assert cache.stats()["shapes_cached"] == 0


def test_rollback_restore_invalidates(delta_on):
    """Topology.restore_counts — the device-fallback abort rollback — drops
    residencies seeded by the aborted solve."""
    engine, solver = _seed_residencies()
    env = PkgEnv(PORT)
    topo = _m(PORT, "scheduler.topology").Topology(
        env.store, env.cluster, env.cluster.state_nodes(), env.pools, env.its, []
    )
    c0 = delta.delta_counters()["delta_invalidations"]
    topo.restore_counts(topo.snapshot_counts())
    assert delta.group_residency(solver).core is None
    assert delta.scan_residency(engine).state is None
    assert delta.delta_counters()["delta_invalidations"] == c0 + 2


def test_debug_view_surfaces_residencies(delta_on):
    engine, solver = _seed_residencies()  # hold refs: the registry is weakref-swept
    view = delta.debug_view()
    assert view["enabled"] is True
    assert view["resolve_full_every"] == 4
    assert "delta_passes_cold" in view["counters"]
    assert view["group_residencies"], "seeded residency missing from view"
    assert view["scan_residencies"][-1]["resident_bytes"] == 32
    assert view["resident_bytes"] > 0


def test_ffd_counters_carry_delta_series(delta_on):
    snap = tffd.solver_cache_counters()
    assert "delta_passes_warm" in snap
    assert "delta_bytes_reencoded" in snap
    assert snap["delta_scan_warm"] == delta.delta_counters()["delta_scan_warm"]


def test_catalog_appends_fresh_rows_on_the_device(delta_on):
    """With delta on, a churn pass's new rows are appended to the resident
    device matrices, the earlier rows untouched, whichever route computed
    them. A one-row batch takes the host twin, as in the reference, whose
    delta-warm exception never fires (nothing stores the resident copy it
    asks for): so no row is metered as device-appended, in either
    package."""
    c0 = {pkg: _m(pkg, "ops.delta").delta_counters().get("delta_rows_device_appended", 0)
          for pkg in (JAX, PORT)}
    for pkg in (JAX, PORT):
        engine = engine_for(pkg)
        rq = _m(pkg, "scheduling.requirements")
        wk = _m(pkg, "apis.labels")
        engine.rows_for(rq.Requirements(rq.Requirement(wk.LABEL_OS, rq.Operator.IN, ["linux"])))
        engine._ensure_rows()
        if pkg == PORT:
            before = engine._req_compat_d.clone()
        engine.rows_for(rq.Requirements(rq.Requirement(wk.LABEL_ARCH, rq.Operator.IN, ["arm64"])))
        engine._ensure_rows()
    for pkg in (JAX, PORT):
        assert _m(pkg, "ops.delta").delta_counters().get("delta_rows_device_appended", 0) == c0[pkg]
    assert engine._req_compat_d.shape[0] == before.shape[0] + 1
    assert torch.equal(engine._req_compat_d[: before.shape[0]], before)
    assert np.array_equal(engine._req_compat_d.numpy(), engine._req_compat)
