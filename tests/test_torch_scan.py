"""The port's fused scan (ops/packer.py, ops/fused.py) against the JAX package's.

The JAX scan (karpenter_tpu/ops/packer.py `solve_scan_fn`) runs on the CPU
under real float64. The reference scopes that with `packer.scan_x64`, which
imports `jax.experimental.enable_x64`, a name this jax release no longer
has; these tests replace `scan_x64` with a context around
`jax.enable_x64(True)` (monkeypatched per test, nothing in karpenter_tpu/
changes), which is what the reference's scope means.

Every comparison is exact (tolerance 0): the scan's outputs are integers
and bools, and its float64 outputs come from the same operations in the
same order, so they match bit for bit.
"""

from __future__ import annotations

import contextlib
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
from karpenter_tpu.ops import feasibility as jfeas  # noqa: E402
from karpenter_tpu.ops import ffd as jffd  # noqa: E402
from karpenter_tpu.ops import fused as jfused  # noqa: E402
from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu.scheduler import nodeclaim as jnodeclaim  # noqa: E402
from karpenter_tpu_torch import convert  # noqa: E402
from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types  # noqa: E402
from karpenter_tpu_torch.device import KernelError  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import ffd as tffd  # noqa: E402
from karpenter_tpu_torch.ops import fused as tfused  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from karpenter_tpu_torch.ops.catalog import CatalogEngine  # noqa: E402
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim  # noqa: E402
from test_torch_solve import cluster_spec, solve, spec, topology_solve  # noqa: E402
from torch_inputs import scan_inputs, uid_inputs  # noqa: E402

torch.set_num_threads(1)

OUT_NAMES = ("abort", "nclaims", "pod_claim", "pod_node", "pod_seq", "claim_ti",
             "claim_fam", "u_valid", "tm_st", "pool_rem")
# (spec builder, seed): odd spec seeds add a second NodePool with a cpu
# limit (T=2, has_limits); cluster seeds add existing nodes with usage
CASES = [("plain", s) for s in range(6)] + [("cluster", s) for s in range(4)]


@contextlib.contextmanager
def _x64():
    with jax.enable_x64(True):
        yield


def _spec(kind: str, seed: int) -> dict:
    return spec(seed) if kind == "plain" else cluster_spec(seed)


@pytest.fixture
def fresh(monkeypatch):
    """Both packages with the fused scan forced on, the JAX scan in real
    float64, device programs on, and fresh hostname/placeholder counters."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr(jfused, "FUSED_MODE", "on")
    monkeypatch.setattr(tfused, "FUSED_MODE", "on")

    def reset():
        for mod in (jnodeclaim, tnodeclaim):
            monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
        for mod in (jffd, tffd):
            monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))

    reset()
    return reset


def _capture_jax_scans(monkeypatch) -> list:
    """Record the JAX scan's numpy operands and outputs on each dispatch."""
    seen = []
    real = jpacker.solve_scan_fn

    def factory(T, has_nodes, has_limits):
        fn = real(T, has_nodes, has_limits)

        def run(*args):
            out = fn(*args)
            seen.append(((T, bool(has_nodes), bool(has_limits)),
                         tuple(np.asarray(a) for a in args),
                         tuple(np.asarray(o) for o in out)))
            return out

        return run

    monkeypatch.setattr(jpacker, "solve_scan_fn", factory)
    return seen


def _assert_outputs_equal(got, want):
    """The reference's 10 outputs, exactly; the port's 11th, the loop's
    iteration count, covers at least one pop per placed pod."""
    assert len(want) == tpacker.SCAN_N_OUT and len(got) == tpacker.SCAN_N_OUT + 1
    assert got[-1].dtype == torch.int32 and int(got[-1]) >= int((want[4] >= 0).sum())
    for name, g, w in zip(OUT_NAMES, got, want):
        g = g.numpy()
        assert g.shape == w.shape, name
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        assert g.tobytes() == w.tobytes(), name


# -- B6 uid_project --------------------------------------------------------------


@pytest.mark.parametrize("lead", [(7,), (1,), (3, 5), (2, 64)])
@pytest.mark.parametrize("seed", range(4))
def test_uid_project_plain_matches_jax(seed, lead):
    onehot, mask = uid_inputs(seed, lead)
    want = np.asarray(jfeas.uid_project(jnp.asarray(onehot), jnp.asarray(mask)))
    got = tfeas.uid_project(torch.from_numpy(onehot), torch.from_numpy(mask))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_uid_onehot_matrix_matches_jax():
    uid_of_type = np.array([2, 0, 1, 2, 2, 0], dtype=np.int64)
    np.testing.assert_array_equal(
        tfeas.uid_onehot_matrix(uid_of_type, 3), jfeas.uid_onehot_matrix(uid_of_type, 3)
    )


# -- B14 the scan, operand for operand ---------------------------------------------


@pytest.mark.parametrize("kind,seed", CASES)
def test_scan_plain_matches_jax_scan(fresh, monkeypatch, kind, seed):
    """The JAX fused solve's own scan operands, captured at dispatch, go
    through the port's plain scan: all 10 outputs equal exactly."""
    seen = _capture_jax_scans(monkeypatch)
    s = _spec(kind, seed)
    solve("karpenter_tpu", s)
    assert len(seen) == 1, "the JAX solve did not run the fused scan"
    cfg, args, want = seen[0]
    assert cfg[1] == (kind == "cluster")
    assert cfg[2] == (seed % 2 == 1) and cfg[0] == (2 if seed % 2 else 1)
    got = tpacker.solve_scan(cfg, convert.scan_operands_from_numpy(args, "cpu"))
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("variant", ["plain", "nodes", "limits", "both"])
@pytest.mark.parametrize("seed", range(4))
def test_scan_plain_matches_jax_on_random_operands(monkeypatch, variant, seed):
    """Random consistent operands (tests/torch_inputs.py, also used on the
    card) reach requeues, cycle stops and fit-edge ties a solve rarely
    does, and seed 3 a claim axis past the kernel's resident design: the
    plain scan still equals the JAX scan exactly."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    cfg, args = scan_inputs(seed, variant in ("nodes", "both"), variant in ("limits", "both"))
    with jpacker.scan_x64():
        want = tuple(np.asarray(o) for o in jpacker.solve_scan_fn(*cfg)(*args))
    n0 = tpacker.LAUNCHES["solve_scan"]
    got = tpacker.solve_scan(cfg, convert.scan_operands_from_numpy(args, "cpu"))
    assert tpacker.LAUNCHES["solve_scan"] == n0  # the plain version launches nothing
    _assert_outputs_equal(got, want)


def test_scan_operands_keep_reference_dtypes():
    cfg, args = scan_inputs(0, True, True)
    ops = convert.scan_operands_from_numpy(args, "cpu")
    for (name, dtype), t, a in zip(convert.SCAN_OPERANDS, ops, args):
        assert t.dtype == dtype, name
        assert tuple(t.shape) == np.shape(a), name
    bad = list(args)
    bad[0] = bad[0].astype(np.float64) + 0.5  # pod_gi not integral
    with pytest.raises(ValueError):
        convert.scan_operands_from_numpy(bad, "cpu")


# -- the kernel's design choice --------------------------------------------------------

# the fused solve's scan at the bench shape (50,000 pods x 1008 types)
BENCH_DIMS = {"C": 2048, "G": 128, "U": 36, "D": 4, "T": 1, "F": 64, "I": 1008, "limits": False}


@pytest.mark.parametrize("dims,want", [
    # 8-byte: keys 2048, g_req and g_floor 2*128*4, uniq_alloc and the rem row
    # 2*36*4, usage0 1*4: 3364 -> 26912; 4-byte: cfit 128 rows of 64|1 = 65
    # words, u_valid 2048*2 words, claim_ti/count/fam 3*2048, famu_ok 1*64*2
    # words, open_uok 1*128*2 words, open_fam 128, dirty 64, the join's
    # misses 144/32 -> 5: 19141 -> 76564; 2-byte: trans_fam 64*128 -> 16384;
    # 1-byte: trans_kind 64*128, tol and open_ok 2*128: 8448. 128308 -> 128320
    (BENCH_DIMS, 128320),
    # C = 8192: keys 65536 + 10528; cfit 128*257, u_valid 8192*2, 3*8192,
    # 128 + 256 + 128, dirty 256, misses 5: 74629 words -> 298516; + 16384 +
    # 8448: 399412 -> 399424
    ({**BENCH_DIMS, "C": 8192}, 399424),
    # limits, small: 8-byte 16 + 96 + 30 + 6 + the pool charge 3 = 151 ->
    # 1208; 4-byte 16 + 16 + 48 + 16 + 32 + 32 + 1 + misses 1 + two uid words
    # 2 = 164 -> 656; 2-byte 256; 1-byte 128 + 64 + the template's uids 5 +
    # three type masks 90 = 287; 2407 -> 2416
    ({"C": 16, "G": 16, "U": 5, "D": 3, "T": 2, "F": 8, "I": 30, "limits": True}, 2416),
])
def test_scan_resident_bytes_by_hand(dims, want):
    assert tpacker.scan_resident_bytes(dims) == want


def _meta(cfg: tuple, ops: tuple) -> tuple:
    return tuple(torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ops)


def _bench_operands(C: int) -> tuple:
    """Operands of the bench shape (P=65536, G=128, U=36, D=4, F=64, T=1, no
    nodes or limits) as meta tensors: shapes and dtypes, no values."""
    P, G, U, D, T, F = 65536, 128, 36, 4, 1, 64
    shapes = [(P,), (C,), (G, D), (G, D), (U, D), (T, D), (T, G), (T, G), (T, G), (T, G, U),
              (F, G), (F, G), (T, F, U), (), (), (1, G), (1, D), (F, 1008), (1, 1), (1, 1, 1),
              (U, 1008), (1,), (1, 1), (T,), (1, D), (1, D), (1,)]
    return tuple(torch.empty(s, dtype=dt, device="meta") for s, (_, dt) in zip(shapes, convert.SCAN_OPERANDS))


def test_scan_design_fits_the_bench_shape_and_not_8192_claims():
    cfg = (1, False, False)
    d = tpacker._scan_dims(cfg, _bench_operands(2048))
    assert all(d[k] == v for k, v in BENCH_DIMS.items() if k != "I")  # I counts with limits only
    assert tpacker.scan_design(cfg, _bench_operands(2048)) == "resident"
    assert tpacker.scan_design(cfg, _bench_operands(4096)) == "resident"
    assert tpacker.scan_design(cfg, _bench_operands(8192)) == "global"


@pytest.mark.parametrize("variant", ["plain", "nodes", "limits", "both"])
@pytest.mark.parametrize("seed", range(4))
def test_scan_design_depends_on_the_dims_alone(variant, seed):
    """The design of real operands is that of meta tensors of the same
    shapes (which hold no values); seed 3's 16384 claim slots take the
    global design, the others the resident one."""
    cfg, args = scan_inputs(seed, variant in ("nodes", "both"), variant in ("limits", "both"))
    ops = convert.scan_operands_from_numpy(args, "cpu")
    design = tpacker.scan_design(cfg, ops)
    assert design == tpacker.scan_design(cfg, _meta(cfg, ops))
    assert design == ("global" if seed == 3 else "resident")


# -- whole solves --------------------------------------------------------------------


@pytest.mark.parametrize("kind,seed", CASES)
def test_fused_solve_matches_jax_fused_and_host_walk(fresh, monkeypatch, kind, seed):
    """The port with the scan on (device="cpu" engine, plain scan) equals
    the JAX package with its scan on, and both equal the JAX host walk:
    claims, per-claim pods, instance-type options, requirements, pod-error
    strings and existing-node joins. Each fused leg counted one fused
    solve and no decline."""
    s = _spec(kind, seed)
    j0, t0 = jfused.FUSED_SOLVES, tfused.FUSED_SOLVES
    jd0, td0 = dict(jfused.FUSED_DECLINES), dict(tfused.FUSED_DECLINES)
    want = solve("karpenter_tpu", s)
    fresh()
    got = solve("karpenter_tpu_torch", s)
    assert (jfused.FUSED_SOLVES, tfused.FUSED_SOLVES) == (j0 + 1, t0 + 1)
    assert (jfused.FUSED_DECLINES, tfused.FUSED_DECLINES) == (jd0, td0)
    assert got == want
    assert got[0], "no claims"
    if kind == "cluster":
        assert got[2], "no pod joined an existing node"
    monkeypatch.setattr(jfused, "FUSED_MODE", "off")
    fresh()
    assert solve("karpenter_tpu", s) == want


# -- declines and faults -------------------------------------------------------------


def _decline_delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _both_decline(fresh, s, reason, solve_fn=solve):
    jd0, td0 = dict(jfused.FUSED_DECLINES), dict(tfused.FUSED_DECLINES)
    j0, t0 = jfused.FUSED_SOLVES, tfused.FUSED_SOLVES
    want = solve_fn("karpenter_tpu", s)
    fresh()
    got = solve_fn("karpenter_tpu_torch", s)
    assert got == want and got[0]
    assert _decline_delta(jd0, jfused.FUSED_DECLINES) == {reason: 1}
    assert _decline_delta(td0, tfused.FUSED_DECLINES) == {reason: 1}
    assert (jfused.FUSED_SOLVES, tfused.FUSED_SOLVES) == (j0, t0)


def test_min_values_declines_to_the_walk(fresh):
    s = spec(0)
    s["pools"][0]["requirements"] = [
        {"key": "node.kubernetes.io/instance-type", "operator": "Exists", "minValues": 2}
    ]
    d0 = tffd.DEVICE_SOLVES
    _both_decline(fresh, s, "min")
    assert tffd.DEVICE_SOLVES == d0 + 1  # the walk, not the host loop


def test_topology_solve_declines(fresh):
    _both_decline(fresh, None, "topo", lambda pkg, _s: topology_solve(pkg))


def test_claim_overflow_declines_to_the_walk(fresh, monkeypatch):
    """A claim axis too small for the batch (a small claim estimate, the
    bucket floor lifted) aborts the scan; the walk re-solves it."""
    for mod in (jfused, tfused):
        real = mod._pow2
        monkeypatch.setattr(mod, "_pow2", lambda n, floor, real=real: 4 if floor == 256 else real(n, floor))
        monkeypatch.setattr(mod._FusedSolve, "_claim_estimate", lambda self, *a: 1)
    d0 = tffd.DEVICE_SOLVES
    _both_decline(fresh, spec(2), "claim-overflow")
    assert tffd.DEVICE_SOLVES == d0 + 1


def test_scan_kernel_error_fails_the_solve(fresh, monkeypatch):
    def broken(cfg, args):
        raise KernelError("solve_scan: CUDA launch failed with cudaError 1")

    monkeypatch.setattr(tpacker, "solve_scan", broken)
    t0, f0 = tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS
    d0 = dict(tfused.FUSED_DECLINES)
    with pytest.raises(KernelError):
        solve("karpenter_tpu_torch", spec(1))
    assert (tffd.DEVICE_SOLVES, tffd.DEVICE_FALLBACKS) == (t0, f0)
    assert tfused.FUSED_DECLINES == d0


def test_decode_divergence_is_a_fault_not_a_decline(fresh, monkeypatch):
    """A pod the scan failed that the host semantics would place (forced
    here: the decode's host recomputation opens a claim for every failed
    pod) raises KernelError; the reference would decline `divergence`."""
    real = tfused._FusedSolve._decode

    def diverging(self, *args):
        self._new_claim = lambda *a: None
        return real(self, *args)

    monkeypatch.setattr(tfused._FusedSolve, "_decode", diverging)
    d0 = dict(tfused.FUSED_DECLINES)
    with pytest.raises(KernelError, match="diverged"):
        solve("karpenter_tpu_torch", spec(0))  # seed 0 leaves pod errors
    assert tfused.FUSED_DECLINES == d0


def test_auto_is_off_for_a_cpu_engine(fresh, monkeypatch):
    monkeypatch.setattr(tfused, "FUSED_MODE", "auto")
    assert not tfused.fused_enabled(CatalogEngine(construct_instance_types()[:8], device="cpu"))
    assert not tfused.fused_enabled(None)
    t0, d0 = tfused.FUSED_SOLVES, tffd.DEVICE_SOLVES
    solve("karpenter_tpu_torch", spec(3))
    assert tfused.FUSED_SOLVES == t0 and tffd.DEVICE_SOLVES == d0 + 1
    counters = tffd.solver_cache_counters()
    assert counters["fused_solves"] == tfused.FUSED_SOLVES
