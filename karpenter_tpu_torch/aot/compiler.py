"""AOT compiler: walk the bucket ladder at boot, load or compile each
executable, persist fresh compiles to the on-disk cache.

``warm_start(engine)`` is the managed replacement for the lazy
``CatalogEngine.warmup()`` cold path: it attaches the active ladder to the
engine (so runtime dispatches pad to ladder buckets), stabilizes the
vocabulary's key capacity (pre-interning the well-known label keys pods
constrain with, so the padded key axis at boot equals the steady-state
one), then for every (kernel, bucket) in the ladder either

- loads its record from the persistent cache (a hit), or
- compiles it ahead of time and writes its record into the cache for the
  next boot,

installing each into the runtime executable table that
``tracing/kernel.dispatch`` consults. Every bucket is recorded into the
kernel observatory under the ``aot-warm`` phase, with ``compiled=True``
only for fresh compiles — which is exactly what the warm-boot perf floor
asserts is zero on a second boot against a warm cache.

What these words mean in this package (a kernel here is built once per
source by nvcc and launched at any shape, where a jit program is compiled
per shape):

- **the compile** of a bucket is the nvcc build of the kernel libraries
  it needs, when they are not built or loaded yet (with a cache, into or
  from ``<cache dir>/kernels/<toolchain>``, so a second boot against a warm
  cache runs no nvcc: ``device.nvcc_runs()``), then ONE launch of the
  bucket's wrapper at its padded shape on zero operands, beside the
  engine's own catalog tensors, so the wrapper's packed tables
  (``feasibility._cached``) are warm and the launch is checked;
- **the executable** (``Executable``) is a small callable: it checks that
  the operands it is given have the bucket's shapes and dtypes (TypeError
  otherwise) and calls the same wrapper the lazy path calls, so decisions
  cannot differ. Its ``cost_analysis()`` gives the bucket's operations and
  bytes from the formulas of ``chip_smoke.py``'s bound column (below);
- **a cache entry** is a small JSON record — the kernel, the signature and
  the digests of the kernel libraries it was checked against — beside the
  cost entry's sidecar JSON. A hit is a record that parses and names the
  libraries of this checkout; it is installed after the same warm launch.

Cache keys embed the catalog content hash (the same fingerprint solverd
content-addresses engines by), the torch, CUDA and nvcc versions, the
device (the card's name, or ``cpu`` for a CPU engine) and the nvcc flags,
the kernel, the bucket signature, and the ladder version — any mismatch is
a miss, so a toolchain bump or a device swap can never load a stale entry.
Corrupt entries are evicted and rebuilt. A kernel that fails to build or to
launch is a KernelError and fails the boot: the lazy path would fail the
same way, so staying on it would only hide the fault.
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from karpenter_tpu_torch import device as devmod
from karpenter_tpu_torch.observability import kernels as kobs
from karpenter_tpu_torch.operator import logging as klog

from karpenter_tpu_torch.aot import ladder as ladder_mod
from karpenter_tpu_torch.aot import runtime as aotrt
from karpenter_tpu_torch.aot.cache import ExecutableCache

_log = klog.logger("aot")


def content_hash(instance_types) -> str:
    """The catalog content fingerprint — the same identity solverd's
    engine factories content-address engines by (provisioner
    _type_fingerprint), hashed for the cache key."""
    from karpenter_tpu_torch.controllers.provisioning.provisioner import (
        _type_fingerprint,
    )

    fp = tuple(_type_fingerprint(it) for it in instance_types)
    return hashlib.sha256(repr(fp).encode()).hexdigest()


# port: the device of the engine being warm-started (None outside a walk:
# the card when there is one, else the CPU)
_ENGINE_DEVICE = contextvars.ContextVar("aot_engine_device", default=None)
# port: nvcc's version line, read once a process
_NVCC_VERSION = []


def _nvcc_version() -> str:
    """nvcc's release line, read once a process; "none" without nvcc."""
    if not _NVCC_VERSION:
        try:
            out = subprocess.run(
                [devmod.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60,
            ).stdout
            lines = [ln for ln in out.splitlines() if "release" in ln]
            _NVCC_VERSION.append(lines[-1].strip() if lines else out.strip() or "?")
        except Exception:  # noqa: BLE001 — no nvcc on this host
            _NVCC_VERSION.append("none")
    return _NVCC_VERSION[0]


def _device_name() -> str:
    """The walk's device: the card's name, or "cpu" for a CPU engine."""
    dev = _ENGINE_DEVICE.get()
    if dev is None:
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(dev)


def _toolchain_fingerprint() -> str:
    """port: torch, CUDA and nvcc versions, the device and the nvcc flags
    (the jax/jaxlib versions and backend in the reference)."""
    return (
        f"torch={torch.__version__};cuda={torch.version.cuda};"
        f"nvcc={_nvcc_version()};device={_device_name()};"
        f"flags={' '.join(devmod.NVCC_FLAGS)}"
    )


def cache_key(
    catalog_hash: str, kernel: str, sig: str, ladder_version: int,
    scope: str = "", donation: str = "",
) -> str:
    """`scope` folds the device layout of a sharded executable into its
    identity (ops/feasibility.mesh_scope) — sharded global shapes are
    mesh-size-invariant by design, so without the scope an executable
    compiled for an 8-way mesh could load into a 1-device process. An
    empty scope (every unsharded kernel) contributes NOTHING to the key,
    so persistent caches filled by pre-mesh builds stay valid.

    `donation` folds a kernel's buffer-donation signature into its
    identity (packer.SCAN_RESUME_DONATE for the delta warm resume):
    input-output aliasing is baked into the compiled executable, so a
    cache entry serialized with donation must never load into a
    non-donating call site or vice versa. Like scope, empty contributes
    nothing — pre-delta caches stay valid."""
    fields = [
        catalog_hash,
        _toolchain_fingerprint(),
        kernel,
        sig,
        f"ladder-v{ladder_version}",
    ]
    if scope:
        fields.append(scope)
    if donation:
        fields.append(donation)
    return hashlib.sha256("\n".join(fields).encode()).hexdigest()


# port: the operations and bytes a bucket needs — the formulas of
# chip_smoke.py's bound column (it reads them from here): 32-bit word
# operations for the feasibility and group kernels, float64 operations for
# the scan; bytes are each operand read once and each output written once.
def words(n: int) -> int:
    """32-bit words holding n bits."""
    return (int(n) + 31) // 32


def row_compat_ops(R: int, N: int, W: int) -> int:
    """One AND per mask word of each (row, target set) pair."""
    return int(R) * int(N) * int(W)


def membership_ops(P: int, I: int, R: int) -> int:
    """One AND per 32-row word of each (entity, type) pair."""
    return int(P) * int(I) * words(R)


def cube_ops(P: int, I: int, O: int, R: int, K: int) -> int:
    """membership_ops, plus the row and custom-key words of each (entity,
    offering) pair."""
    return membership_ops(P, I, R) + int(P) * int(O) * (words(R) + words(K))


def solve_block_ops(G: int, R: int, I: int, O: int, K: int, D: int) -> int:
    """cube_ops over the groups, plus the fit test and the argmin over the
    types (D + 1 a type)."""
    return cube_ops(G, I, O, R, K) + int(G) * int(I) * (int(D) + 1)


def scan_ops(steps: int, G: int, U: int, D: int, N: int) -> int:
    """float64 compares and subtractions per step: the claims' fit rows,
    the taken claim's headroom update and the existing nodes' fit test."""
    return int(steps) * (int(G) * int(U) * int(D) + 2 * int(U) * int(D) + int(N) * int(D))


# -- abstract-shape builders --------------------------------------------------


class OperandSpec:
    """port: the (shape, dtype, device) of one operand — the stand-in for
    jax.ShapeDtypeStruct. A warm launch gets zeros of it."""

    __slots__ = ("shape", "dtype", "device")

    def __init__(self, shape, dtype, device):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype).name
        self.device = torch.device(device)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize

    def zeros(self) -> torch.Tensor:
        return torch.zeros(self.shape, dtype=getattr(torch, self.dtype), device=self.device)


class _Deferred:
    """port: an operand made when the warm launch runs (the engine's own
    tensors, or a tuple of them the signature leaves out)."""

    __slots__ = ("make",)

    def __init__(self, make):
        self.make = make


def _sds(shape, dtype, device):
    """port: an OperandSpec (a jax.ShapeDtypeStruct in the reference; the
    device in place of its sharding)."""
    return OperandSpec(shape, dtype, device)


def _sig(args) -> str:
    return kobs.shape_signature(args)


def _dtype_name(x) -> Optional[str]:
    dt = getattr(x, "dtype", None)
    if dt is None:
        return None
    return str(dt).replace("torch.", "")


def _materialize(args) -> tuple:
    out = []
    for a in args:
        if isinstance(a, OperandSpec):
            out.append(a.zeros())
        elif isinstance(a, _Deferred):
            out.append(a.make())
        else:
            out.append(a)
    return tuple(out)


def _nbytes(*xs) -> int:
    total = 0
    for x in xs:
        if isinstance(x, OperandSpec):
            total += x.nbytes
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


class Executable:
    """port: one (kernel, bucket)'s entry in the runtime executable table.
    A call checks that the operands have the bucket's shapes and dtypes —
    TypeError otherwise, which the named dispatch answers by discarding the
    entry and launching lazily — then calls `fn`, the same wrapper the lazy
    path calls. `cost` is the bucket's {"flops", "bytes accessed"}: the
    operations and bytes of chip_smoke.py's bound column. The operands of
    the warm launch (`args`: specs, the engine's tensors) are held until it
    has run; `specs` keeps each one's shape and dtype (None: an operand the
    signature leaves out)."""

    def __init__(self, kernel: str, fn, args: tuple, sig: str, cost: dict, device):
        self.kernel = kernel
        self.fn = fn
        self.sig = sig
        self.cost = cost
        self.device = torch.device(device)
        self.specs = tuple(
            a if isinstance(a, OperandSpec)
            else OperandSpec(a.shape, _dtype_name(a), getattr(a, "device", "cpu"))
            if getattr(a, "shape", None) is not None else None
            for a in args
        )
        self._operands = args

    def __call__(self, *args):
        if len(args) != len(self.specs):
            raise TypeError(f"{self.kernel}: {len(args)} operands for a {len(self.specs)}-operand bucket")
        for i, (spec, a) in enumerate(zip(self.specs, args)):
            if spec is None:
                continue
            got = tuple(int(d) for d in getattr(a, "shape", ()))
            if got != spec.shape or _dtype_name(a) != spec.dtype:
                raise TypeError(
                    f"{self.kernel}: operand {i} is {_dtype_name(a)}{list(got)}, "
                    f"the bucket's {spec.dtype}{list(spec.shape)}"
                )
        return self.fn(*args)

    def cost_analysis(self) -> dict:
        return dict(self.cost)

    def libraries(self) -> dict:
        """{source name: library file} of the checkout's kernel libraries
        (none for a CPU engine: the plain versions). All of them, not only
        the one this bucket launches: device.build_kernels builds and loads
        every csrc/*.cu at once, so a changed source makes every entry
        stale."""
        if self.device.type != "cuda":
            return {}
        return {name: devmod.library_name(name, src) for name, src in devmod._sources().items()}

    def warm(self) -> None:
        """Build or load the kernel libraries, then one launch at the
        bucket's shape on zero operands, waited for. A failure of either is
        a KernelError."""
        if self.device.type == "cuda":
            devmod.build_kernels()
        from karpenter_tpu_torch.tracing import kernel as ktime

        with devmod.device_work(f"warm start of {self.kernel} at {self.sig}"):
            out = self.fn(*_materialize(self._operands))
            ktime._fence(out)
        self._operands = None

    def record(self) -> bytes:
        """The cache entry's body."""
        return json.dumps(
            {"kernel": self.kernel, "sig": self.sig, "libraries": self.libraries()},
            sort_keys=True,
        ).encode()

    def check_record(self, body: bytes) -> None:
        """Raise unless `body` is this bucket's record against this
        checkout's kernel libraries."""
        rec = json.loads(body.decode())
        want = json.loads(self.record().decode())
        if rec != want:
            raise ValueError(f"stale entry: {rec} is not {want}")


def _plan(kernel, fn, args, device, cost, scope="", donation="") -> tuple:
    """port: (kernel, fn, args, sig, scope, donation, device, cost) — the
    reference's plan tuple, with the device the warm launch runs on and the
    bucket's cost."""
    return (kernel, fn, args, _sig(args), scope, donation, device, cost)


def _cost(ops: int, *operands, extra_bytes: int = 0) -> dict:
    """A bucket's cost entry: `ops` operations, and the operands' bytes plus
    `extra_bytes` (the outputs, and rows a kernel reads by index)."""
    return {"flops": float(ops), "bytes accessed": float(_nbytes(*operands) + extra_bytes)}


def _cube_plans(engine, ladder: ladder_mod.Ladder) -> list[tuple]:
    """(kernel, fn, args, sig, ...) per feasibility bucket. The engine
    routes through the cube when it has offerings, membership_all when it
    has none — mirror that so only reachable executables build.

    port: the cube's operands as CatalogEngine.feasibility dispatches them:
    the membership and key planes at the bucket's shape, the used row ids
    and the resident row matrices (read by index, outside the signature),
    the engine's offering tables."""
    from karpenter_tpu_torch.ops import catalog as catmod
    from karpenter_tpu_torch.ops import feasibility as feas

    I, O, K = engine.num_instances, engine.num_offerings, engine._key_capacity
    dev = engine.device
    b = np.bool_
    plans = []
    if O:
        cn = engine._dev("custom_need", engine.offering_custom_need)
        av = engine._dev("available", engine.offering_available)
        ow = engine._dev("owner", engine.offering_owner)
        for P, R in ladder.buckets("feasibility.cube"):
            args = (
                _sds((P, R), b, dev),
                _sds((P, K), b, dev),
                _Deferred(lambda R=R: _resident_rows(engine, R)),
                cn, av, ow,
            )
            cost = _cost(
                cube_ops(P, I, O, R, K), args[0], args[1], cn, av, ow,
                extra_bytes=2 * P * I + 4 * R + R * (I + O),
            )
            plans.append(_plan("feasibility.cube", catmod._cube, args, dev, cost))
    else:
        for P, R in ladder.buckets("feasibility.membership"):
            args = (_sds((P, R), b, dev), _sds((R, I), b, dev))
            cost = _cost(membership_ops(P, I, R), *args, extra_bytes=P * I)
            plans.append(_plan("feasibility.membership", feas.membership_all, args, dev, cost))
    return plans


def _resident_rows(engine, R: int) -> tuple:
    """port: the cube's row operand for a warm launch: R row ids (0) into
    the engine's resident matrices (one all-False row before the first row
    is interned)."""
    dev = engine.device
    ids = torch.zeros(R, dtype=torch.int32, device=dev)
    if engine._computed_rows:
        return ids, engine._req_compat_d, engine._offer_compat_d
    return (
        ids,
        torch.zeros((1, engine.num_instances), dtype=torch.bool, device=dev),
        torch.zeros((1, engine.num_offerings), dtype=torch.bool, device=dev),
    )


def _row_compat_plans(engine, ladder: ladder_mod.Ladder) -> list[tuple]:
    """Row-kernel buckets, one executable per row bucket.

    port: one executable covers the types and the offerings — the port's
    row batch is ONE launch against both target sets (the reference's, one
    a target set); the operands as CatalogEngine._ensure_rows dispatches
    them."""
    from karpenter_tpu_torch.ops import catalog as catmod
    from karpenter_tpu_torch.ops import feasibility as feas

    W = engine._word_capacity
    dev = engine.device
    tables = (
        engine._dev("slot_key", engine._tables.slot_key),
        engine._dev("value_int", engine._tables.value_int),
    )
    sets = engine._set_args("inst", engine._inst_sets)
    N = engine.num_instances
    if engine.num_offerings:
        sets += engine._set_args("offer", engine._offer_sets)
        N += engine.num_offerings
    plans = []
    seen = set()
    for (R,) in ladder.buckets("catalog.row_compat"):
        args = (_sds((R, feas.ROW_FIELDS + W), np.int32, dev),) + tables + sets
        sig = _sig(args)
        if sig in seen:
            continue
        seen.add(sig)
        cost = _cost(row_compat_ops(R, N, W), *args, extra_bytes=R * N)
        plans.append(_plan("catalog.row_compat", catmod._row_compat, args, dev, cost))
    return plans


def _mesh_shardings(mesh):
    """port: where a mesh dispatch's entity axis lives — on the host (the
    wrapper stages each shard's slab; the catalog comes as one copy a
    shard, mesh.Replicas)."""
    return torch.device("cpu")


def _sharded_cube_plans(engine, ladder: ladder_mod.Ladder) -> list[tuple]:
    """Mesh twins of the cube plans: global bucket shapes with the serving
    path's exact input layout (entity axes on the host, split over the
    mesh; catalog matrices replicated). Only buckets the mesh splits evenly
    compile — the others are unreachable by construction (bucket_for
    multiple_of)."""
    from karpenter_tpu_torch.ops import feasibility as feas

    mesh = engine.mesh
    n = mesh.size
    host = _mesh_shardings(mesh)
    scope = feas.mesh_scope(mesh)
    I, O, K = engine.num_instances, engine.num_offerings, engine._key_capacity
    dev = engine.device
    b = np.bool_
    cn = _Deferred(lambda: engine._mesh_dev("custom_need", engine.offering_custom_need))
    av = _Deferred(lambda: engine._mesh_dev("available", engine.offering_available))
    ow = _Deferred(lambda: engine._mesh_dev("owner", engine.offering_owner))
    plans = []
    for P, R in ladder.buckets("feasibility.cube_sharded"):
        if P % n:
            continue
        args = (
            _sds((P, R), b, host),
            _sds((R, I), b, dev),
            _sds((R, O), b, dev),
            cn,
            _sds((P, K), b, host),
            av,
            ow,
        )
        cost = _cost(
            cube_ops(P, I, O, R, K), *args, extra_bytes=2 * P * I + O * (K + 5),
        )
        plans.append(
            _plan("feasibility.cube_sharded", feas.sharded_cube(mesh), args, dev, cost, scope)
        )
    return plans


def _sharded_solve_block_plans(engine, ladder: ladder_mod.Ladder) -> list[tuple]:
    """Mesh twins of the packer plans (group axis on the host, split over
    the mesh; catalog replicated), launched through the SAME wrapper the
    serving path dispatches (packer.sharded_solve_block)."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    mesh = engine.mesh
    n = mesh.size
    host = _mesh_shardings(mesh)
    scope = feas.mesh_scope(mesh)
    I, O, K = engine.num_instances, engine.num_offerings, engine._key_capacity
    R = max(1, engine._computed_rows)
    D = len(engine.resource_dims)
    b, i32 = np.bool_, np.int32
    solver = packer.GroupSolver(engine, mesh=mesh)
    catalog = solver._mesh_catalog_args(mesh)
    fn = packer.sharded_solve_block(mesh)
    cat_bytes = sum(_nbytes(c[0]) for c in catalog)
    plans = []
    for (G,) in ladder.buckets("packer.solve_block_sharded"):
        if G % n:
            continue
        args = (_sds((G, R + K), b, host), _sds((G, D + 1), i32, host)) + tuple(catalog)
        cost = _cost(
            solve_block_ops(G, R, I, O, K, D), *args[:2], extra_bytes=16 * G + cat_bytes,
        )
        plans.append(_plan("packer.solve_block_sharded", fn, args, engine.device, cost, scope))
    return plans


def _solve_scan_plans(engine, ladder: ladder_mod.Ladder) -> list[tuple]:
    """Fused-scan rungs: one executable per (pods, groups, claims, nodes,
    fams, templates, limited-pools) bucket, through the SAME callable the
    serving path dispatches (packer.solve_scan_fn). Only built when the
    fused path is enabled — a fused-off boot never pays the scan's
    launches."""
    from karpenter_tpu_torch.ops import fused as fused_mod
    from karpenter_tpu_torch.ops import packer

    from karpenter_tpu_torch.ops import delta as delta_mod

    dev = engine.device
    plans = []
    for bucket in ladder.buckets("packer.solve_scan"):
        if len(bucket) != 7:
            continue
        P, G, _C, N, _F, T, L = bucket
        args = fused_mod.solve_scan_abstract_args(engine, bucket)
        U, D = args[4].shape[0], args[2].shape[1]
        extra_bytes = sum(
            int(np.prod(shape, dtype=np.int64)) * torch.tensor([], dtype=dt).element_size()
            for _name, shape, dt in packer._state_spec((int(T), N > 0, L > 0), args)
        )
        cost = _cost(scan_ops(P, G, U, D, N), *args, extra_bytes=extra_bytes)
        fn = packer.solve_scan_fn(int(T), N > 0, L > 0)
        plans.append(_plan("packer.solve_scan", fn, args, dev, cost))
        if not delta_mod.delta_enabled():
            continue
        # delta-solve twins of the rung: the cold scan that returns the
        # full residency state, and the warm resume that continues it in
        # place. The reference's donation signature stays part of the
        # resume's persistent identity (cache_key): in the port it is only
        # a tag kept for key parity, no buffer is donated (the resume
        # writes its state operands in place whatever the key says).
        full = packer.solve_scan_full_fn(int(T), N > 0, L > 0)
        plans.append(_plan("packer.solve_scan_full", full, args, dev, cost))
        state = fused_mod.solve_scan_state_abstract_args(engine, bucket)
        rargs = args + state + (_sds((), np.int32, dev),)
        resume = packer.solve_scan_resume_fn(int(T), N > 0, L > 0)
        donation = "donate={}-{}".format(
            packer.SCAN_RESUME_DONATE[0], packer.SCAN_RESUME_DONATE[-1]
        )
        plans.append(_plan(
            "packer.solve_scan_resume", resume, rargs, dev,
            _cost(scan_ops(P, G, U, D, N), *rargs, extra_bytes=extra_bytes), "", donation,
        ))
    return plans


def _solve_block_plans(engine, ladder: ladder_mod.Ladder) -> list[tuple]:
    """Packer buckets. The catalog-side row axis is the engine's CURRENT
    interned row count (taken after warmup, when the probe rows exist) —
    rows interned later shift the signature and dispatch off-table, which
    the ladder view surfaces."""
    from karpenter_tpu_torch.ops import packer

    I, O, K = engine.num_instances, engine.num_offerings, engine._key_capacity
    R = max(1, engine._computed_rows)
    D = len(engine.resource_dims)
    dev = engine.device
    b, i32 = np.bool_, np.int32
    catalog = packer.GroupSolver(engine)._catalog_args()
    plans = []
    for (G,) in ladder.buckets("packer.solve_block"):
        args = (_sds((G, R + K), b, dev), _sds((G, D + 1), i32, dev)) + catalog
        cost = _cost(solve_block_ops(G, R, I, O, K, D), *args, extra_bytes=16 * G)
        plans.append(_plan("packer.solve_block", packer.solve_block, args, dev, cost))
    return plans


# -- the warm start -----------------------------------------------------------


def _ensure_executable(
    plan: tuple,
    catalog_hash: str,
    ladder: ladder_mod.Ladder,
    cache: Optional[ExecutableCache],
    registry,
    summary: dict,
) -> None:
    """Load-or-compile one bucket; installs into the runtime table,
    records the bucket into the observatory (phase aot-warm), and notes
    its cost model into the efficiency tables (once per bucket — the
    perf floor asserts zero per-pass cost_analysis calls).

    port: a corrupt or stale cache entry is evicted and the bucket rebuilt,
    as in the reference; a kernel that fails to build or to launch raises
    KernelError and fails the boot (the reference logs its compile failure
    and stays on lazy JIT)."""
    from karpenter_tpu_torch.observability import efficiency

    kernel, fn, args, sig, scope, donation, device, cost = plan
    summary["buckets"] += 1
    loaded = aotrt.lookup(kernel, sig, scope)
    if loaded is not None:
        # another engine with identical content already warmed this bucket
        # this process — record it like a cache hit so warm-start telemetry
        # is a pure function of the walk, not of process history
        summary["already_loaded"] += 1
        registry.record(kernel, sig, 0.0, compiled=False, fenced=False, aot=True)
        efficiency.note_executable(kernel, sig, loaded, scope=scope)
        return
    key = cache_key(
        catalog_hash, kernel, sig, ladder.version, scope=scope,
        donation=donation,
    )
    exe = Executable(kernel, fn, args, sig, cost, device)
    t0 = time.perf_counter()
    if cache is not None:
        body = cache.get(key)
        if body is not None:
            try:
                exe.check_record(body)
            except Exception as e:  # noqa: BLE001 — bad entry: evict, recompile
                cache.evict(key, f"deserialize: {e}")
            else:
                exe.warm()
                aotrt.install(kernel, sig, exe, scope=scope)
                cache.count_hit()  # a hit = an executable actually served
                summary["cache_hits"] += 1
                registry.record(
                    kernel, sig, time.perf_counter() - t0,
                    compiled=False, fenced=False, aot=True,
                )
                # cost tables ride the warm start: one cost_analysis per
                # bucket, answered from the sidecar JSON when the cache
                # already holds it
                efficiency.note_executable(
                    kernel, sig, exe, scope=scope, cache=cache, key=key
                )
                return
    exe.warm()
    seconds = time.perf_counter() - t0
    aotrt.install(kernel, sig, exe, scope=scope)
    summary["fresh_compiles"] += 1
    registry.record(kernel, sig, seconds, compiled=True, fenced=True, aot=False)
    efficiency.note_executable(
        kernel, sig, exe, scope=scope, cache=cache, key=key
    )
    if cache is not None:
        cache.put(key, exe.record())


def _library_dir(cache: ExecutableCache) -> str:
    """port: where a cache's kernel libraries live: one directory per
    toolchain fingerprint under <cache dir>/kernels."""
    import os

    tag = hashlib.sha256(_toolchain_fingerprint().encode()).hexdigest()[:16]
    return os.path.join(cache.root, "kernels", tag)


def warm_start(
    engine,
    ladder: Optional[ladder_mod.Ladder] = None,
    cache: Optional[ExecutableCache] = None,
) -> Optional[dict]:
    """Walk the ladder for `engine`: attach the ladder, stabilize vocab
    capacities, load/compile every bucket, then run the engine's own warmup
    (whose probe dispatch now rides the executable table). Idempotent per
    engine.

    A mesh-sharded engine walks the `_sharded` twin plans instead — same
    buckets as GLOBAL shapes — with the mesh shape folded into both the
    runtime table scope and the persistent cache key (a restart under a
    different mesh shape is a cache miss, never a wrong load). The row
    kernel stays single-device on either path.

    port: with a cache on a CUDA engine, the kernel libraries are built
    into or loaded from the cache's library directory (_library_dir) for
    the walk, the build directory again after it; the
    fingerprint names the engine's device; the routing probe is the
    engine device's (`catmod.device_rtt_s(engine.device)`), and its
    failure, a KernelError, fails the boot.

    Returns the walk summary (buckets / cache_hits / fresh_compiles /
    already_loaded / errors), or None when AOT is disabled."""
    if ladder is None:
        ladder = aotrt.active_ladder()
    if cache is None:
        cache = aotrt.active_cache()
    if ladder is None or engine is None:
        if engine is not None:
            engine.warmup()
        return None
    if getattr(engine, "_aot_warmed", False):
        engine.warmup()
        return getattr(engine, "_aot_summary", None)
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.ops import catalog as catmod

    summary = {
        "buckets": 0,
        "cache_hits": 0,
        "fresh_compiles": 0,
        "already_loaded": 0,
        "errors": 0,
    }
    engine.aot_ladder = ladder
    # stabilize the key axis: pods constrain with well-known label keys (+
    # hostname), so interning them now means the padded key capacity at
    # boot equals the steady-state one — without this, the first batch's
    # key interning grows K past the AOT'd shapes and every bucket misses
    for key in sorted(set(wk.WELL_KNOWN_LABELS) | {wk.LABEL_HOSTNAME}):
        engine.vocab.key_id(key)
    engine._maybe_reencode()
    catmod.device_rtt_s(engine.device)  # device init + routing probe
    token = _ENGINE_DEVICE.set(engine.device)
    libraries = (
        devmod.use_library_dir(_library_dir(cache))
        if cache is not None and engine.device.type == "cuda"
        else contextlib.nullcontext()
    )
    try:
        chash = content_hash(engine.instance_types)
        registry = kobs.registry()
        with libraries, registry.phase_scope("aot-warm"):
            # a mesh engine serves its sweeps through the sharded twins
            cube_plans = (
                _sharded_cube_plans(engine, ladder)
                if engine.mesh is not None and engine.num_offerings
                else _cube_plans(engine, ladder)
            )
            for plan in cube_plans:
                _ensure_executable(plan, chash, ladder, cache, registry, summary)
            for plan in _row_compat_plans(engine, ladder):
                _ensure_executable(plan, chash, ladder, cache, registry, summary)
            # warmup AFTER the feasibility buckets exist (its probe dispatch
            # rides the table) and BEFORE the packer plans (whose row axis is
            # the post-probe interned row count)
            engine.warmup()
            packer_plans = (
                _sharded_solve_block_plans(engine, ladder)
                if engine.mesh is not None
                else _solve_block_plans(engine, ladder)
            )
            for plan in packer_plans:
                _ensure_executable(plan, chash, ladder, cache, registry, summary)
            # fused-scan rungs: only when the fused path can dispatch them
            # (mode on, or auto on a CUDA engine). Mesh engines launch the
            # scan replicated without a table entry.
            from karpenter_tpu_torch.ops import fused as fused_mod

            if fused_mod.fused_enabled(engine) and engine.mesh is None:
                for plan in _solve_scan_plans(engine, ladder):
                    _ensure_executable(plan, chash, ladder, cache, registry, summary)
    finally:
        _ENGINE_DEVICE.reset(token)
    aotrt.note_warm_start(summary["fresh_compiles"])
    engine._aot_warmed = True
    engine._aot_summary = summary
    _log.info(
        "AOT warm start complete",
        buckets=summary["buckets"],
        cache_hits=summary["cache_hits"],
        fresh_compiles=summary["fresh_compiles"],
        already_loaded=summary["already_loaded"],
        errors=summary["errors"],
    )
    return summary
