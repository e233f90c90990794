"""The port's AOT ladder, executable cache and runtime table (aot/ladder.py,
aot/cache.py, aot/runtime.py, copies of the reference's) against the JAX
package's, on the CPU.

The reference's tests/test_aot.py cases that need no AOT compiler (the
compiler is not ported yet: `aot.warm_start` raises the missing module's
error in the port), each run on both packages with equal results; the
runtime's executable table consulted by the port's named dispatch; and the
ladder derived from the port's own observed counts — the fused scan's
27-operand signature included.
"""

from __future__ import annotations

import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_delta import JAX, PORT, _m  # noqa: E402

PKGS = [JAX, PORT]


class Pkg:
    def __init__(self, pkg: str):
        self.name = pkg
        self.ladder = _m(pkg, "aot.ladder")
        self.cache = _m(pkg, "aot.cache")
        self.runtime = _m(pkg, "aot.runtime")
        self.kobs = _m(pkg, "observability.kernels")
        self.ktime = _m(pkg, "tracing.kernel")
        self.metrics = _m(pkg, "metrics").global_registry

    def tiny(self):
        return self.ladder.make({
            "feasibility.cube": [(1, 4), (4, 8)],
            "catalog.row_compat": [(32,)],
            "packer.solve_block": [(8,)],
        })


@pytest.fixture
def clean():
    """Both packages' runtime tables, off-ladder state and registries reset."""
    def reset():
        for pkg in PKGS:
            p = Pkg(pkg)
            p.kobs.registry().reset()
            p.runtime.configure(None, None)
            p.runtime.clear_executables()
            p.runtime.reset_off_ladder()

    reset()
    yield
    reset()


def twin(fn):
    """fn(Pkg) on both packages; the results, which must be equal."""
    seen = {pkg: fn(Pkg(pkg)) for pkg in PKGS}
    assert seen[PORT] == seen[JAX]
    return seen[PORT]


# -- the ladder -----------------------------------------------------------------


def test_bucket_for_picks_smallest_fit_and_off_ladder():
    def run(p):
        d = p.ladder.DEFAULT
        return [d.bucket_for("feasibility.cube", (3, 5)), d.bucket_for("feasibility.cube", (1, 1)),
                d.bucket_for("catalog.row_compat", (40,)), d.bucket_for("feasibility.cube", (4096, 4)),
                d.bucket_for("unknown.kernel", (1,)), d.bucket_for("feasibility.cube", (1,)),
                d.bucket_for("packer.solve_scan", (600, 40, 300, 0, 50, 1, 0)),
                d.bucket_for("feasibility.cube_sharded", (5, 3), multiple_of=8)]

    got = twin(run)
    assert got[:3] == [(8, 16), (1, 4), (64,)] and got[3:6] == [None, None, None]


def test_serialization_round_trip_and_resolve(tmp_path):
    def run(p):
        path = tmp_path / f"{p.name}.json"
        path.write_text(p.tiny().dumps())
        assert p.ladder.load(str(path)) == p.tiny() == p.ladder.resolve(str(path))
        assert p.ladder.resolve("") is None and p.ladder.resolve("off") is None
        assert p.ladder.resolve("default") is p.ladder.DEFAULT
        return p.tiny().dumps(), p.ladder.DEFAULT.dumps(), p.ladder.LADDER_VERSION

    twin(run)


def test_mesh_multiple_and_kernels():
    twin(lambda p: ([p.ladder.mesh_multiple(n) for n in (1, 2, 3, 8, 12)],
                    dict(p.ladder.LADDER_KERNELS), p.ladder.MESH_ALIGN))


COUNTS = {
    "feasibility.cube": {
        "shapes": {"3x5,5x144,...": {"warmup": 1, "steady": 4}, "9x9,...": {"host": 2},
                   "512x4,4x144": {"steady": 1}, "64x64,64x144": {"steady": 1}},
        "recompiles": 0,
    },
    "catalog.row_compat": {"shapes": {"40,40,40": {"steady": 1}}, "recompiles": 0},
}


@pytest.mark.parametrize("headroom", [0, 1, 2])
def test_from_observatory_rounds_up_device_buckets(headroom):
    def run(p):
        lad = p.ladder.from_observatory(COUNTS, headroom=headroom)
        return lad.to_dict()

    got = twin(run)
    assert [64] in got["kernels"]["catalog.row_compat"]
    if headroom:
        assert [1024, 128] in got["kernels"]["feasibility.cube"]


def test_scan_signature_dims_parse():
    """A 27-segment scan signature (the port's packer.solve_scan operands,
    observability/kernels.shape_signature) parses to the same 7 axes in
    both packages: nodes and limits absent as 1x1 dummies."""
    sig = ",".join(["600", "300", "40x4", "40x4", "9x4", "9x4", "2x40x9", "2x40", "2x40",
                    "2x40x9", "50x40", "50x40", "1x50x9", "1", "1", "1x1", "1x1", "50x144",
                    "1x1", "1x1x1", "9x144", "1", "1x1", "1", "1x1", "1x1", "1"])
    assert len(sig.split(",")) == 27
    got = twin(lambda p: (p.ladder._scan_signature_dims(sig), p.ladder._scan_signature_dims("1,2")))
    assert got == ((1024, 64, 512, 0, 64, 16, 0), None)


# -- the executable cache ----------------------------------------------------------


def _stats(cache) -> dict:
    """A cache's counters without its root (each package writes its own
    directory)."""
    return {k: v for k, v in cache.stats().items() if k != "root"}


def cache_round_trip(p, root):
    c = p.cache.ExecutableCache(str(root))
    miss = c.get("k" * 64)
    c.put("k" * 64, b"payload")
    body = c.get("k" * 64)
    c.count_hit()
    c.put("p" * 64, b"not a pickled executable")
    c.evict("p" * 64, "deserialize: boom")
    return miss, body, c.get("p" * 64), _stats(c)


def cache_corruption(p, root):
    c = p.cache.ExecutableCache(str(root))
    c.put("a" * 64, b"good bytes")
    path = c._path("a" * 64)
    with open(path, "r+b") as f:
        f.seek(len(p.cache.MAGIC) + 70)
        f.write(b"XXXX")
    corrupt = (c.get("a" * 64), os.path.exists(path))
    c.put("b" * 64, b"a longer body that will be cut")
    path = c._path("b" * 64)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    truncated = (c.get("b" * 64), os.path.exists(path))
    path = c._path("c" * 64)
    open(path, "wb").write(b"not an aot entry at all")
    bad_magic = (c.get("c" * 64), os.path.exists(path))
    return corrupt, truncated, bad_magic, _stats(c)


def cache_concurrent_writers(p, root):
    c1, c2 = p.cache.ExecutableCache(str(root)), p.cache.ExecutableCache(str(root))
    body, errors = b"x" * 4096, []

    def writer(c):
        try:
            for _ in range(50):
                c.put("e" * 64, body)
                got = c.get("e" * 64)
                assert got is None or got == body
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(c,)) for c in (c1, c2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return errors, c1.get("e" * 64) == body, c1.stats()["evictions"]


def cache_read_only(p, root, monkeypatch):
    c = p.cache.ExecutableCache(str(root))
    c.put("f" * 64, b"pre-existing")

    def deny(*args, **kwargs):
        raise PermissionError("read-only file system")

    with monkeypatch.context() as m:
        m.setattr(p.cache.os, "replace", deny)
        wrote = c.put("g" * 64, b"new entry")
    litter = [q for q in os.listdir(root) if ".tmp." in q]
    target = root / "file"
    target.write_text("occupied")
    uncreatable = p.cache.ExecutableCache(str(target / "sub"))
    return wrote, c.stats()["write_errors"], c.get("f" * 64), litter, \
        uncreatable.get("h" * 64), uncreatable.put("h" * 64, b"x")


@pytest.mark.parametrize("case", ["round_trip", "corruption", "concurrent", "read_only"])
def test_executable_cache_matches_the_reference(tmp_path, monkeypatch, case):
    fn = {"round_trip": cache_round_trip, "corruption": cache_corruption,
          "concurrent": cache_concurrent_writers,
          "read_only": lambda p, r: cache_read_only(p, r, monkeypatch)}[case]
    seen = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        root.mkdir()
        seen[pkg] = fn(Pkg(pkg), root)
    assert seen[PORT] == seen[JAX]
    if case == "round_trip":
        assert seen[PORT][:3] == (None, b"payload", None)
    if case == "corruption":
        assert seen[PORT][:3] == ((None, False),) * 3


# -- the runtime: table, off-ladder accounting, views -------------------------------


def test_off_ladder_counts_warns_once_and_fires_callbacks(clean):
    def run(p):
        rt = p.runtime
        fired = []
        rt.on_off_ladder(lambda k, s: fired.append((k, s)), key="spec")
        ctr = p.metrics.get("karpenter_aot_offladder_dispatches_total")
        base = ctr.value({"kernel": "spec.k", "mesh": ""})
        rt.note_off_ladder("spec.k", "1024x8")
        rt.note_off_ladder("spec.k", "1024x8")
        rt.note_off_ladder("spec.k", "64", mesh="mesh=2:pods")
        return fired, ctr.value({"kernel": "spec.k", "mesh": ""}) - base, \
            rt.stats()["off_ladder_dispatches"], rt.ladder_view()["off_ladder"]

    fired, moved, count, view = twin(run)
    assert fired == [("spec.k", "1024x8")] * 2 + [("spec.k", "64@mesh=2:pods")]
    assert moved == 2 and count == view["count"] == 3


def test_table_install_lookup_discard_and_scopes(clean):
    def run(p):
        rt = p.runtime
        rt.install("spec.k", "4", "exe-a")
        rt.install("spec.k", "4", "exe-b", scope="mesh=2:pods")
        out = [rt.lookup("spec.k", "4"), rt.lookup("spec.k", "4", "mesh=2:pods"),
               rt.lookup(None, "4"), rt.lookup("spec.k", "8"), rt.executables()]
        rt.discard("spec.k", "4", error="boom")
        out += [rt.lookup("spec.k", "4"), rt.executables()]
        rt.note_warm_start(3)
        base = rt.stats()
        rt.note_warm_start(2)
        out += [rt.stats_delta(base)]
        return out

    got = twin(run)
    assert got[:2] == ["exe-a", "exe-b"] and got[5] is None


def test_broken_executable_falls_back_and_discards(clean):
    """An installed executable that raises at call time: the named dispatch
    falls back to the kernel and drops it from the table, in both."""
    def run(p):
        calls = []

        def broken(*args):
            calls.append(1)
            raise TypeError("aval mismatch")

        if p.name == JAX:
            f, x = jax.jit(lambda x: x * 2.0), jnp.ones((6,))
        else:
            f, x = (lambda x: x * 2.0), torch.ones((6,))
        sig = p.kobs.shape_signature((x,))
        p.runtime.install("spec.broken", sig, broken)
        ctr = p.metrics.get("karpenter_aot_executable_fallbacks_total")
        base = ctr.value({"kernel": "spec.broken"})
        out = float(np.asarray(p.ktime.dispatch(f, x, kernel="spec.broken"))[0])
        p.ktime.dispatch(f, x, kernel="spec.broken")
        snap = p.kobs.registry().debug_snapshot("spec.broken")
        return (out, calls, p.runtime.lookup("spec.broken", sig),
                ctr.value({"kernel": "spec.broken"}) - base, snap["dispatches"], snap["aot_served"])

    assert twin(run) == (2.0, [1], None, 1, 2, 0)


def test_installed_executable_serves_the_named_dispatch(clean):
    """A (kernel, shape, scope) in the table is served instead of the
    kernel, counted as aot_served; another scope misses."""
    def run(p):
        x = jnp.ones((3,)) if p.name == JAX else torch.ones((3,))
        sig = p.kobs.shape_signature((x,))
        p.runtime.install("spec.aot", sig, lambda a: "from the table", scope="mesh=2:pods")
        served = p.ktime.dispatch(lambda a: "from the kernel", x, kernel="spec.aot",
                                  aot_scope="mesh=2:pods")
        missed = p.ktime.dispatch(lambda a: "from the kernel", x, kernel="spec.aot")
        snap = p.kobs.registry().debug_snapshot("spec.aot")
        return served, missed, snap["aot_served"], snap["dispatches"]

    assert twin(run) == ("from the table", "from the kernel", 1, 2)


def test_ladder_view(clean, tmp_path):
    def run(p):
        disabled = p.kobs.registry().debug_snapshot(view="ladder")
        assert disabled["enabled"] is False and disabled["ladder"] == {} and disabled["cache"] is None
        root = tmp_path / p.name
        root.mkdir()
        p.runtime.configure(p.tiny(), p.cache.ExecutableCache(str(root)))
        reg = p.kobs.registry()
        reg.record("feasibility.cube", "4x8,8x144", 0.001, False, True)
        reg.record_host("feasibility.cube", "2x2")
        p.runtime.install("feasibility.cube", "4x8,8x144", object())
        p.runtime.note_off_ladder("feasibility.cube", "2048x4")
        view = reg.debug_snapshot(view="ladder")
        view["executables"] = list(view["executables"])
        view["cache"] = {k: v for k, v in view["cache"].items() if k != "root"}
        return view

    view = twin(run)
    assert view["enabled"] is True and [4, 8] in view["ladder"]["feasibility.cube"]
    assert view["off_ladder"]["count"] == 1
    assert any(r.get("on_ladder") for r in view["observed"]["feasibility.cube"])


def test_configure_from_options(clean, tmp_path):
    def run(p):
        rt = p.runtime
        rt.configure_from_options(types.SimpleNamespace(compile_cache_dir=str(tmp_path), aot_ladder=""))
        a = (rt.enabled(), rt.active_ladder() is p.ladder.DEFAULT, rt.active_cache().root)
        rt.configure_from_options(types.SimpleNamespace(compile_cache_dir="", aot_ladder="off"))
        b = rt.enabled()
        rt.configure_from_options(types.SimpleNamespace(compile_cache_dir="", aot_ladder="default"))
        return a, b, rt.enabled(), rt.active_cache()

    assert twin(run) == ((True, True, str(tmp_path)), False, True, None)


def test_warm_start_waits_for_the_compiler():
    """aot/__init__.py is a verbatim copy: its lazy compiler import raises
    Python's error for the absent module until the port has an AOT
    compiler; the rest of the package's surface is there."""
    from karpenter_tpu_torch import aot

    with pytest.raises(ImportError, match="compiler"):
        aot.warm_start(object())
    assert aot.Ladder is aot.ladder.Ladder and aot.LADDER_VERSION == aot.ladder.LADDER_VERSION


def test_ladder_from_the_ports_observed_scan(clean, monkeypatch):
    """A fused solve on the port records its scan under the 27-operand
    signature; the ladder derived from those counts carries the scan rung
    the reference derives from its own."""
    import test_torch_solve as tsolve
    from karpenter_tpu.ops import catalog as jcatalog
    from karpenter_tpu.ops import fused as jfused
    from karpenter_tpu.ops import packer as jpacker
    from karpenter_tpu_torch.ops import fused as tfused
    from test_torch_delta import _x64

    monkeypatch.setattr(jpacker, "scan_x64", _x64)
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr(jfused, "FUSED_MODE", "on")
    monkeypatch.setattr(tfused, "FUSED_MODE", "on")

    def run(p):
        scheduler, pods = tsolve.build_solve(p.name, tsolve.spec(4))
        scheduler.solve(pods)
        lad = p.ladder.from_observatory(p.kobs.registry().counts_snapshot(), headroom=1)
        return lad.to_dict()["kernels"]["packer.solve_scan"]

    rungs = twin(run)
    assert len(rungs) == 2 and all(len(r) == 7 for r in rungs)
