"""Explain funnels: the port's decision provenance against the JAX package's.

After the reference's `run_explain_case` (tests/test_device_parity.py):
the explain recorder on in both packages, each package's Scheduler.solve on
the same numpy-seeded spec (tests/test_torch_solve.py `spec` seeds 0-5 and
`cluster_spec` seeds 0-2, each with the fused scan off and on) plus two
ride-along pods that cannot schedule anywhere, so every case has ledger
rows. After each solve the staged funnels commit as the solverd coalescer
commits them (`commit_solve`). The JAX engine runs its device programs
(FORCE_BACKEND="device", STRICT, so a device fault raises instead of
falling back to the host loop); its scan runs under real float64
(`packer.scan_x64` monkeypatched to `jax.enable_x64(True)`, as
tests/test_torch_scan.py does: the reference's own import of
`jax.experimental.enable_x64` is gone from this jax). The port's engine runs
device="cpu" (its plain torch versions).

Held equal, exactly: the decisions (claims, their pods, instance-type
options and requirements, pod errors, existing nodes' pods) and the per-pod
ledger of every failed pod (its error, its classified stages, and the
per-nodepool funnel: pool walk order, stages, error text).
"""

from __future__ import annotations

import contextlib
import importlib
import itertools
import os
import sys

import jax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import catalog as jcatalog  # noqa: E402
from karpenter_tpu.ops import ffd as jffd  # noqa: E402
from karpenter_tpu.ops import fused as jfused  # noqa: E402
from karpenter_tpu.ops import packer as jpacker  # noqa: E402
from karpenter_tpu.scheduler import nodeclaim as jnodeclaim  # noqa: E402
from karpenter_tpu_torch.ops import ffd as tffd  # noqa: E402
from karpenter_tpu_torch.ops import fused as tfused  # noqa: E402
from karpenter_tpu_torch.scheduler import nodeclaim as tnodeclaim  # noqa: E402
from test_torch_solve import build_solve, cluster_spec, decisions, spec  # noqa: E402

torch.set_num_threads(1)

# (spec builder, seed): odd spec seeds add a second NodePool with a cpu
# limit; cluster seeds add existing nodes with seeded usage
CASES = [("spec", s) for s in range(6)] + [("cluster", s) for s in range(3)]
# the reference's two ride-along pods: one too large for any type, one
# selecting a zone no offering has
UNSAT = (
    ("xx-giant", {}, {"cpu": "9999"}),
    ("xx-lost-zone", {"topology.kubernetes.io/zone": "zone-nowhere"}, {"cpu": "1"}),
)


@contextlib.contextmanager
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture
def explain_both(monkeypatch):
    """Both packages' explain recorders on and reset, the JAX engine on its
    device programs under STRICT with the scan in real float64, and fresh
    hostname and placeholder counters; everything restored after."""
    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr(jffd, "STRICT", True)
    for mod in (jnodeclaim, tnodeclaim):
        monkeypatch.setattr(mod, "_hostname_counter", itertools.count(1))
    for mod in (jffd, tffd):
        monkeypatch.setattr(mod, "_placeholder_counter", itertools.count(1))
    mods = [importlib.import_module(f"{pkg}.observability.explain")
            for pkg in ("karpenter_tpu", "karpenter_tpu_torch")]
    saved = [m.recorder().mode or "off" for m in mods]
    for m in mods:
        m.configure(mode="on")
        m.recorder().reset()
    yield
    for m, mode in zip(mods, saved):
        m.configure(mode=mode)
        m.recorder().reset()


def explain_solve(pkg: str, s: dict):
    """One solve of the spec plus the ride-along pods with the recorder on:
    (decisions, the ledger of every failed pod by name)."""
    rec = importlib.import_module(f"{pkg}.observability.explain").recorder()
    rec.reset()
    scheduler, pods = build_solve(pkg, s, UNSAT)
    results = scheduler.solve(pods)
    rec.commit_solve(pods, results.pod_errors, kind="solve")
    ledger = []
    for p in sorted(results.pod_errors, key=lambda p: p.metadata.name):
        e = rec.entry(p.metadata.uid)
        assert e is not None, f"{pkg}: no ledger entry for failed pod {p.metadata.name}"
        ledger.append((
            e["pod"], e["error"], tuple(e["stages"]),
            tuple((f["nodepool"], tuple(f["stages"]), f["error"]) for f in e["funnel"]),
        ))
    return decisions(results), ledger


@pytest.mark.parametrize("fused", [False, True], ids=["fused-off", "fused-on"])
@pytest.mark.parametrize("kind,seed", CASES)
def test_explain_ledger_matches_jax(explain_both, monkeypatch, kind, seed, fused):
    mode = "on" if fused else "off"
    monkeypatch.setattr(jfused, "FUSED_MODE", mode)
    monkeypatch.setattr(tfused, "FUSED_MODE", mode)
    s = spec(seed) if kind == "spec" else cluster_spec(seed)
    j0, t0 = jffd.DEVICE_SOLVES, tffd.DEVICE_SOLVES
    jf0, tf0 = jfused.FUSED_SOLVES, tfused.FUSED_SOLVES
    want, want_ledger = explain_solve("karpenter_tpu", s)
    got, got_ledger = explain_solve("karpenter_tpu_torch", s)
    # both took their device path, and the fused scan in both or in neither
    assert jffd.DEVICE_SOLVES == j0 + 1 and tffd.DEVICE_SOLVES == t0 + 1
    assert tfused.FUSED_SOLVES - tf0 == jfused.FUSED_SOLVES - jf0 == (1 if fused else 0)
    assert got == want
    assert got_ledger == want_ledger
    names = {row[0] for row in got_ledger}
    assert {"xx-giant", "xx-lost-zone"} <= names
    assert all(row[3] for row in got_ledger), "a failed pod without a funnel"
