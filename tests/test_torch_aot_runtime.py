"""The port's AOT ladder, executable cache and runtime table (aot/ladder.py,
aot/cache.py, aot/runtime.py, copies of the reference's) against the JAX
package's, on the CPU.

The reference's tests/test_aot.py scenarios of the ladder, the cache and
the runtime, each run on both packages with equal results; the runtime's
executable table consulted by the port's named dispatch; the ladder derived
from the port's own observed counts — the fused scan's 27-operand signature
included. Then the port's own parts of the compiler (aot/compiler.py; its
twins of tests/test_aot.py are tests/test_torch_aot_compiler.py): a
KernelError from an installed executable or from a warm launch fails the
dispatch, Provisioner.prewarm() and the daemon's engine rebuild; the
executable's signature check; corrupt and stale entries evicted and
rebuilt; a CPU engine's entries missing for another device; and the
library directory a second boot loads from without nvcc.
"""

from __future__ import annotations

import json
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
    import torch_twins as tw

    def reset():
        for pkg in PKGS:
            Pkg(pkg).kobs.registry().reset()
            tw.reset_aot(pkg)

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


def test_warm_start_waits_for_the_compiler(clean):
    """aot.warm_start reaches the port's compiler (it raised ImportError
    before aot/compiler.py was ported): without a ladder it runs the lazy
    warmup and returns None; with one it walks the ladder on the engine's
    device. The rest of the package's surface is there."""
    from karpenter_tpu_torch import aot
    from karpenter_tpu_torch.aot import compiler

    engine = _cpu_engine()
    assert aot.warm_start(engine) is None and engine._warmed and engine.aot_ladder is None
    summary = aot.warm_start(_cpu_engine(), ladder=Pkg(PORT).tiny())
    assert summary == {"buckets": 4, "cache_hits": 0, "fresh_compiles": 4, "already_loaded": 0,
                       "errors": 0}
    assert aot.warm_start is not compiler.warm_start and callable(compiler.warm_start)
    assert aot.Ladder is aot.ladder.Ladder and aot.LADDER_VERSION == aot.ladder.LADDER_VERSION


def _cpu_engine():
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    return CatalogEngine(construct_instance_types(), device="cpu")


def _kernel_error():
    from karpenter_tpu_torch.device import KernelError

    return KernelError


def _failing_warm(monkeypatch, kernel: str):
    """Every warm launch of `kernel`'s buckets raises a KernelError, as a
    kernel that fails to build or to launch does."""
    from karpenter_tpu_torch.aot import compiler

    KernelError = _kernel_error()
    real = compiler.Executable.warm

    def warm(self):
        if self.kernel == kernel:
            raise KernelError(f"warm start of {self.kernel} at {self.sig}: cudaError 700")
        return real(self)

    monkeypatch.setattr(compiler.Executable, "warm", warm)


# -- the port's parts: faults, the executable, the cache --------------------------------


def test_kernel_error_from_an_installed_executable_fails_the_dispatch(clean):
    """port: a KernelError out of an installed executable leaves the named
    dispatch — no second, lazy launch, nothing discarded (the reference
    degrades every failure to its jit path)."""
    p = Pkg(PORT)
    KernelError = _kernel_error()
    lazy = []

    def faulting(*args):
        raise KernelError("kt_cube: cudaError 700")

    x = torch.ones((5,))
    sig = p.kobs.shape_signature((x,))
    p.runtime.install("spec.fault", sig, faulting)
    ctr = p.metrics.get("karpenter_aot_executable_fallbacks_total")
    base = ctr.value({"kernel": "spec.fault"})
    with pytest.raises(KernelError, match="cudaError 700"):
        p.ktime.dispatch(lambda a: lazy.append(a), x, kernel="spec.fault")
    assert lazy == [] and p.runtime.lookup("spec.fault", sig) is faulting
    assert ctr.value({"kernel": "spec.fault"}) == base


def test_executable_checks_the_bucket_signature(clean):
    """An executable takes only its bucket's shapes and dtypes (TypeError
    otherwise, which the dispatch answers by discarding it and launching
    lazily); on them it calls the wrapper the lazy path calls."""
    from karpenter_tpu_torch.aot import compiler

    spec = compiler.OperandSpec((4, 8), "bool", "cpu")
    exe = compiler.Executable("spec.sig", lambda m: m.sum(), (spec,), "4x8", {"flops": 1.0}, "cpu")
    assert int(exe(torch.ones((4, 8), dtype=torch.bool))) == 32
    for bad in (torch.ones((4, 9), dtype=torch.bool), torch.ones((4, 8), dtype=torch.int32)):
        with pytest.raises(TypeError, match="bucket"):
            exe(bad)
    with pytest.raises(TypeError):
        exe()
    p = Pkg(PORT)
    p.runtime.install("spec.sig", "4x9", exe)
    out = p.ktime.dispatch(lambda m: "lazy", torch.ones((4, 9), dtype=torch.bool), kernel="spec.sig")
    assert out == "lazy" and p.runtime.lookup("spec.sig", "4x9") is None
    assert exe.cost_analysis() == {"flops": 1.0} and exe.libraries() == {}
    # a card's record names every kernel library of the checkout (the
    # build makes all of them at once), so a changed source makes it stale
    from karpenter_tpu_torch import device as tdevice

    card = compiler.Executable("spec.sig", None, (), "", {}, "cuda")
    libs = card.libraries()
    assert sorted(libs) == sorted(tdevice._sources()) and {"feasibility", "packer", "scan"} <= set(libs)
    assert all(libs[n] == tdevice.library_name(n, s) for n, s in tdevice._sources().items())


def test_kernel_error_in_the_warm_start_fails_prewarm(clean, monkeypatch, tmp_path):
    """port: Provisioner.prewarm() raises a KernelError of the warm start
    (the reference logs every failure and falls back to the lazy warmup)."""
    import torch_twins as tw

    _failing_warm(monkeypatch, "feasibility.cube")
    options = tw._m(PORT, "operator.options").Options(compile_cache_dir=str(tmp_path))
    Pkg(PORT).runtime.configure_from_options(options)
    helpers = tw.module("helpers", PORT)
    _clock, store, _provider, _cluster, _informer, prov = tw.port_provisioner_harness(options)
    store.create(helpers.nodepool("workers"))
    with pytest.raises(_kernel_error(), match="cudaError 700"):
        prov.prewarm()


def test_kernel_error_in_the_warm_start_fails_the_daemon_rebuild(clean, monkeypatch):
    """port: the daemon's engine rebuild raises the warm start's KernelError,
    and the request's reply is that error, typed (the reference's rebuild
    logs it and stays on lazy JIT)."""
    import torch_twins as tw
    from karpenter_tpu_torch import solverd as sd
    from karpenter_tpu_torch.solverd.transport import _default_engine_factory
    from karpenter_tpu_torch.utils.clock import Clock
    from test_torch_solverd import seeded_scheduler

    _failing_warm(monkeypatch, "catalog.row_compat")
    p = Pkg(PORT)
    p.runtime.configure(p.ladder.DEFAULT, None)
    factory = _default_engine_factory(device="cpu")
    catalog = _cpu_engine().instance_types
    with pytest.raises(_kernel_error(), match="catalog.row_compat"):
        factory(catalog)
    svc = sd.SolverService(clock=Clock())
    daemon = sd.SolverDaemon(svc, address="127.0.0.1:0",
                             engine_factory=_default_engine_factory(device="cpu")).start()
    client = sd.SocketClient(daemon.address)
    try:
        with tw.leg(PORT), pytest.raises(_kernel_error(), match="cudaError 700"):
            client.solve(sd.KIND_SOLVE, *seeded_scheduler(PORT, 5, _cpu_engine()), timeout=60.0)
    finally:
        client.close()
        daemon.stop()
        svc.close()


def test_corrupt_entry_is_evicted_and_rebuilt(clean, tmp_path):
    """One truncated cache entry: the next boot evicts it and rebuilds that
    bucket alone (one fresh compile), the rest are hits."""
    p = Pkg(PORT)
    cache = p.cache.ExecutableCache(str(tmp_path))
    p.runtime.configure(p.tiny(), cache)
    from karpenter_tpu_torch import aot

    cold = aot.warm_start(_cpu_engine())
    entries = sorted(n for n in os.listdir(tmp_path) if n.endswith(".aotx"))
    assert len(entries) == cold["buckets"] == cold["fresh_compiles"]
    path = os.path.join(tmp_path, entries[0])
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    p.runtime.clear_executables()
    warm = aot.warm_start(_cpu_engine())
    assert warm["fresh_compiles"] == 1 and warm["cache_hits"] == warm["buckets"] - 1
    assert cache.stats()["evictions"] == 1 and os.path.getsize(path) == len(raw)


def test_stale_record_is_evicted_and_rebuilt(clean, tmp_path):
    """A record that parses but names other kernel libraries (the sources
    changed under an unchanged key) is evicted and its bucket rebuilt."""
    from karpenter_tpu_torch import aot

    p = Pkg(PORT)
    cache = p.cache.ExecutableCache(str(tmp_path))
    p.runtime.configure(p.tiny(), cache)
    aot.warm_start(_cpu_engine())
    p.runtime.clear_executables()
    for name in os.listdir(tmp_path):
        if name.endswith(".aotx"):
            key = name[: -len(".aotx")]
            rec = json.loads(cache.get(key).decode())
            rec["libraries"] = {"feasibility": "libfeasibility_0000000000000000.so"}
            cache.put(key, json.dumps(rec).encode())
    warm = aot.warm_start(_cpu_engine())
    assert warm["cache_hits"] == 0 and warm["fresh_compiles"] == warm["buckets"]
    assert cache.stats()["evictions"] == warm["buckets"]


def test_cpu_entries_miss_for_another_device(clean, tmp_path, monkeypatch):
    """The fingerprint names the device: entries a CPU engine wrote are
    misses for a card (another device string), never wrong loads."""
    from karpenter_tpu_torch import aot
    from karpenter_tpu_torch.aot import compiler

    p = Pkg(PORT)
    cache = p.cache.ExecutableCache(str(tmp_path))
    p.runtime.configure(p.tiny(), cache)
    assert "device=cpu" in compiler._toolchain_fingerprint() or torch.cuda.is_available()
    cold = aot.warm_start(_cpu_engine())
    key_cpu = compiler.cache_key("cat", "feasibility.cube", "1x4", 1)
    monkeypatch.setattr(compiler, "_device_name", lambda: "NVIDIA H100 80GB HBM3")
    assert compiler.cache_key("cat", "feasibility.cube", "1x4", 1) != key_cpu
    assert "device=NVIDIA H100 80GB HBM3" in compiler._toolchain_fingerprint()
    p.runtime.clear_executables()
    other = aot.warm_start(_cpu_engine())
    assert other["cache_hits"] == 0 and other["fresh_compiles"] == cold["buckets"]
    assert cache.stats()["evictions"] == 0


def test_library_dir_second_boot_runs_no_nvcc(monkeypatch, tmp_path):
    """device.py with a library directory (the AOT cache's): the first boot
    runs nvcc once per source into it; a second process (nothing loaded)
    loads every library from it and runs no nvcc — build_count grows,
    nvcc_runs does not; the build directory is back after each block. nvcc
    is a stand-in that writes its -o file, and ctypes.CDLL is stubbed."""
    from karpenter_tpu_torch import device as tdevice

    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(tdevice, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(tdevice, "ctypes", types.SimpleNamespace(CDLL=lambda path: path))
    monkeypatch.setattr(tdevice, "_libs", {})
    build_dir = tdevice._lib_dir
    libdir = tmp_path / "cache" / "kernels" / "tag"
    n_src = len(tdevice._sources())
    runs, built = tdevice.nvcc_runs(), tdevice.build_count()
    with tdevice.use_library_dir(str(libdir)):
        libs = tdevice.build_kernels()
    assert tdevice._lib_dir == build_dir  # the block's end restores it
    assert tdevice.nvcc_runs() == runs + n_src and tdevice.build_count() == built + n_src
    assert sorted(os.listdir(libdir)) == sorted(
        tdevice.library_name(n, s) for n, s in tdevice._sources().items()
    )
    assert all(path.startswith(str(libdir)) for path in libs.values())
    monkeypatch.setattr(tdevice, "_libs", {})  # a second process
    with tdevice.use_library_dir(str(libdir)):
        tdevice.build_kernels()
    assert tdevice.nvcc_runs() == runs + n_src and tdevice.build_count() == built + 2 * n_src


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
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")
    monkeypatch.setattr(jfused, "FUSED_MODE", "on")
    monkeypatch.setattr(tfused, "FUSED_MODE", "on")

    def run(p):
        scheduler, pods = tsolve.build_solve(p.name, tsolve.spec(4))
        scheduler.solve(pods)
        lad = p.ladder.from_observatory(p.kobs.registry().counts_snapshot(), headroom=1)
        return lad.to_dict()["kernels"]["packer.solve_scan"]

    rungs = twin(run)
    assert len(rungs) == 2 and all(len(r) == 7 for r in rungs)
