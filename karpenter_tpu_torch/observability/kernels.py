"""The kernel observatory: per-kernel compile/memory accounting behind one
instrumented-dispatch choke point.

Every jitted entry point in the repo (the packer solve block, the
feasibility cubes, the catalog row kernel — and their host twins and the
topo count-tensor resyncs) reports into one process-global
``KernelRegistry`` via ``tracing/kernel.dispatch(..., kernel=...)``. Per
kernel it records: compile count and compile wall, execute wall, the
padded input shape signature (the bucket key), jit-cache hit/miss, and a
phase label — ``warmup`` until the registry is **sealed** post-prewarm,
``steady`` after.

The seal is the zero-recompile steady-state contract (ROADMAP item 2's
measurement floor): any compile observed after ``seal()`` is a
*recompile* — it increments ``karpenter_kernel_recompiles_total{kernel=}``
and fires the registered callbacks (the provisioner publishes a
``KernelRecompiled`` warning event), making "steady-state never
recompiles" a machine-checked invariant instead of a hope.

Determinism contract (same as tracing/): dispatch COUNTS per
(kernel, shape bucket, phase) are pure functions of the scenario under
the sim's pinned routing, so the sim's ``report["kernels"]`` is built from
``counts_snapshot()`` deltas and digested; WALL measurements and compile
counts are process history (a warm second run legitimately skips the
compile a cold first run paid) and live only in the report's ``volatile``
section and on ``/debug/kernels``.
"""

from __future__ import annotations

import contextvars
import hashlib
import json
import sys
import threading
import time
from contextlib import contextmanager
from typing import Callable, Iterator, Optional, Sequence

from karpenter_tpu_torch.metrics import global_registry

_DISPATCHES = global_registry.counter(
    "karpenter_kernel_dispatches_total",
    "device kernel dispatches through the instrumented choke point",
    labels=["kernel", "phase"],
)
_COMPILES = global_registry.counter(
    "karpenter_kernel_compiles_total",
    "XLA compiles per kernel (a dispatch that grew the jit cache)",
    labels=["kernel", "phase"],
)
_RECOMPILES = global_registry.counter(
    "karpenter_kernel_recompiles_total",
    "compiles observed AFTER the registry was sealed post-prewarm — the "
    "zero-recompile steady-state contract being violated",
    labels=["kernel"],
)
_COMPILE_WALL = global_registry.histogram(
    "karpenter_kernel_compile_seconds",
    "wall time of compiling dispatches per kernel",
    labels=["kernel"],
    buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)
# per-shape-bucket execute latency: the data that chooses the AOT bucket
# ladder (ROADMAP item 2) — which padded shapes run, how often, how slow
_EXECUTE_WALL = global_registry.histogram(
    "karpenter_kernel_execute_seconds",
    "fenced execute wall time per kernel and padded-shape bucket",
    labels=["kernel", "bucket"],
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
             0.5, 1.0, 2.5),
)
_LIVE_BYTES = global_registry.gauge(
    "karpenter_device_live_array_bytes",
    "total bytes of live jax arrays held by the process (engine matrices, "
    "cached device uploads)",
)
_DEVICE_MEM = global_registry.gauge(
    "karpenter_device_memory_bytes",
    "per-device allocator stats (bytes_in_use / peak_bytes_in_use / "
    "bytes_limit) where the backend reports them",
    labels=["device", "stat"],
)

# "aot-warm" is the AOT warm-start walk (aot/compiler): ladder buckets
# loaded from the persistent cache or compiled ahead of time at boot
_PHASES = ("warmup", "steady", "aot-warm", "host")

# phase override for the CURRENT thread of control only (the AOT warm-start
# walk): a contextvar, NOT registry state — a daemon thread warm-starting a
# rebuilt engine must not relabel (or recompile-exempt) concurrent solve
# threads' dispatches
_PHASE_OVERRIDE: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "karpenter_kernel_phase_override", default=None
)

# per-batch dispatch accumulator (the one-dispatch-solve proof surface):
# opened by batch_scope() around each solverd batch / provisioner solve;
# contextvar-scoped so concurrent daemon threads never mix batches
_BATCH: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "karpenter_kernel_batch", default=None
)
_BATCH_RING_CAP = 64
# per-batch dispatch timeline entries kept on a ring entry: enough to read
# the shape of a solve (the fused path is 1; the host walk is a handful of
# sweeps), bounded so a pathological batch can't grow the ring entry
_TIMELINE_CAP = 64
_BATCH_DISPATCHES = global_registry.histogram(
    "karpenter_kernel_batch_dispatches",
    "device dispatches per solve batch (steady-state contract: <=1)",
    buckets=(0.0, 1.0, 2.0, 3.0, 5.0, 10.0, 25.0, 100.0),
)
_HOST_STALL = global_registry.histogram(
    "karpenter_kernel_host_stall_fraction",
    "fraction of each steady solve batch's wall the device sat idle for "
    "(1.0 = fully host-paced; the efficiency observatory's per-batch "
    "attribution)",
    buckets=(0.05, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0),
)


class _Shape:
    """Per-(kernel, padded-shape-bucket) accounting."""

    __slots__ = ("dispatches", "compiles", "fenced", "execute_s", "max_s",
                 "phases", "aot_served", "enqueue_s", "block_s")

    def __init__(self):
        self.dispatches = 0
        self.compiles = 0
        self.fenced = 0  # dispatches whose execute wall was fence-measured
        self.execute_s = 0.0
        self.max_s = 0.0
        self.phases = {"warmup": 0, "steady": 0, "aot-warm": 0, "host": 0}
        self.aot_served = 0  # dispatches served by an AOT executable
        # the execute wall split (efficiency observatory): host-side call
        # vs block_until_ready wait, fenced dispatches only
        self.enqueue_s = 0.0
        self.block_s = 0.0


class _Kernel:
    __slots__ = ("name", "dispatches", "compiles", "recompiles",
                 "host_dispatches", "compile_s", "execute_s", "phases",
                 "shapes", "aot_served")

    def __init__(self, name: str):
        self.name = name
        self.dispatches = 0
        self.compiles = 0
        self.recompiles = 0
        self.host_dispatches = 0
        self.compile_s = 0.0
        self.execute_s = 0.0
        self.phases = {"warmup": 0, "steady": 0, "aot-warm": 0}
        self.shapes: dict[str, _Shape] = {}
        self.aot_served = 0


def shape_signature(args: Sequence) -> str:
    """The padded input shape signature — the bucket key jit executables
    are effectively keyed by. Array-shaped args contribute their dims;
    everything else is ignored (static scalars don't select executables
    for the repo's kernels)."""
    dims = []
    for a in args:
        shape = getattr(a, "shape", None)
        if shape is None:
            continue
        dims.append("x".join(str(int(d)) for d in shape) or "1")
    return ",".join(dims) or "scalar"


class KernelRegistry:
    """Process-global per-kernel accounting + the seal contract."""

    def __init__(self):
        self._lock = threading.Lock()
        self._kernels: dict[str, _Kernel] = {}
        self._sealed = False
        self._recompile_cbs: dict[str, Callable[[str, str], None]] = {}
        self._recompile_events: list[dict] = []
        self._last_memory: Optional[dict] = None
        self._batches: list[dict] = []  # recent per-batch dispatch counts
        self._batch_seq = 0
        # cumulative steady-batch efficiency counters (the sim's
        # report["kernels"]["efficiency"] reads deltas): batch counts and
        # dispatch counts are deterministic facts; the wall sums are
        # machine facts that never enter a digest
        self._eff = {
            "steady_batches": 0,
            "device_batches": 0,
            "host_only_batches": 0,
            "device_dispatches": 0,
            "busy_s": 0.0,
            "gap_s": 0.0,
            "wall_s": 0.0,
        }

    # -- phase / seal --------------------------------------------------------

    @property
    def sealed(self) -> bool:
        return self._sealed

    @property
    def phase(self) -> str:
        return "steady" if self._sealed else "warmup"

    def seal(self) -> None:
        """Close the warmup window: from here on every compile is a contract
        violation. Idempotent — the provisioner calls it after every
        prewarm pass."""
        with self._lock:
            self._sealed = True

    def unseal(self) -> None:
        """Reopen the warmup window (sim run start, daemon restart tests)."""
        with self._lock:
            self._sealed = False

    def reset(self) -> None:
        """Tests only: drop all records, callbacks, and the seal."""
        with self._lock:
            self._kernels.clear()
            self._sealed = False
            self._recompile_cbs.clear()
            self._recompile_events.clear()
            self._last_memory = None
            self._batches.clear()
            self._batch_seq = 0
            for key in self._eff:
                self._eff[key] = 0.0 if key.endswith("_s") else 0

    @contextmanager
    def phase_scope(self, phase: str) -> Iterator[None]:
        """Label every dispatch recorded by the CURRENT thread of control
        inside as `phase` (one of _PHASES). The AOT warm-start walk runs
        under phase_scope("aot-warm") so its ladder loads/compiles are
        distinguishable from the lazy warmup path — and so a compile inside
        the walk never counts as a steady-state recompile even on a
        post-seal re-warm. Contextvar-scoped: a daemon thread warm-starting
        a rebuilt engine never relabels concurrent solve threads."""
        token = _PHASE_OVERRIDE.set(phase)
        try:
            yield
        finally:
            _PHASE_OVERRIDE.reset(token)

    @contextmanager
    def batch_scope(self, label: str = "") -> Iterator[dict]:
        """Count DEVICE dispatches (every non-host record() in the current
        thread of control) for one solve batch, and file the result into a
        bounded recent-batches ring surfaced on /debug/kernels. This is the
        runtime proof surface for the one-dispatch-solve contract: a steady
        fused batch must show dispatches == 1. The yielded dict accumulates
        live, so callers can also read it after the scope closes.

        The scope also reconstructs the batch's dispatch TIMELINE (the
        efficiency observatory): device-busy wall (fenced execute walls),
        host gap (batch wall minus busy), and a per-batch
        ``host_stall_fraction``. Host twins (record_host) and unfenced
        dispatches never contribute to device-busy time — a batch with no
        awaited device work is fully host-paced, fraction exactly 1.0."""
        acc: dict = {
            "label": label,
            "dispatches": 0,
            "kernels": {},
            "fenced": 0,
            "host_records": 0,
            "device_busy_s": 0.0,
            "enqueue_s": 0.0,
            "block_s": 0.0,
            "timeline": [],
        }
        token = _BATCH.set(acc)
        t0 = time.perf_counter()
        try:
            yield acc
        finally:
            wall = time.perf_counter() - t0
            _BATCH.reset(token)
            phase = "steady" if self._sealed else "warmup"
            busy = acc["device_busy_s"]
            gap = max(0.0, wall - busy)
            # division is exact at the edges: busy == 0 gives exactly 1.0
            fraction = (
                min(1.0, max(0.0, gap / wall)) if wall > 0 else None
            )
            acc["wall_s"] = round(wall, 6)
            acc["host_gap_s"] = round(gap, 6)
            acc["host_stall_fraction"] = (
                round(fraction, 6) if fraction is not None else None
            )
            with self._lock:
                self._batch_seq += 1
                entry = {
                    "seq": self._batch_seq,
                    "label": label,
                    "phase": phase,
                    "dispatches": acc["dispatches"],
                    "kernels": dict(acc["kernels"]),
                    "fenced": acc["fenced"],
                    "host_records": acc["host_records"],
                    "wall_s": acc["wall_s"],
                    "device_busy_s": round(busy, 6),
                    "host_gap_s": acc["host_gap_s"],
                    "host_stall_fraction": acc["host_stall_fraction"],
                    "timeline": list(acc["timeline"]),
                }
                self._batches.append(entry)
                del self._batches[:-_BATCH_RING_CAP]
                if phase == "steady":
                    eff = self._eff
                    eff["steady_batches"] += 1
                    if acc["dispatches"]:
                        eff["device_batches"] += 1
                    else:
                        eff["host_only_batches"] += 1
                    eff["device_dispatches"] += acc["dispatches"]
                    eff["busy_s"] += busy
                    eff["gap_s"] += gap
                    eff["wall_s"] += wall
            _BATCH_DISPATCHES.observe(float(acc["dispatches"]))
            if phase == "steady" and fraction is not None:
                _HOST_STALL.observe(fraction)

    def last_batches(self, n: int = _BATCH_RING_CAP) -> list[dict]:
        with self._lock:
            return [dict(b) for b in self._batches[-n:]]

    def on_recompile(self, cb: Callable[[str, str], None], key: str = "default") -> None:
        """Register a (kernel, shape) callback fired on post-seal compiles.
        Keyed replace semantics: re-registration (a new Operator in the same
        process) swaps the slot instead of accumulating dead callbacks."""
        with self._lock:
            self._recompile_cbs[key] = cb

    # -- recording (called from tracing/kernel.dispatch) ---------------------

    def record(
        self, kernel: str, shape: str, seconds: float, compiled: bool,
        fenced: bool, aot: bool = False,
        enqueue_s: float = 0.0, block_s: float = 0.0,
    ) -> None:
        cbs: tuple = ()
        recompiled = False
        override = _PHASE_OVERRIDE.get()
        batch = _BATCH.get()
        if batch is not None:
            batch["dispatches"] += 1
            batch["kernels"][kernel] = batch["kernels"].get(kernel, 0) + 1
            # device-busy attribution: only FENCED, non-compiling dispatches
            # contribute measured device wall (a compile's wall is host-side
            # XLA work; an unfenced dispatch's device work was never awaited
            # here, so claiming it as busy would undercount the host gap)
            if fenced and not compiled:
                batch["fenced"] += 1
                batch["device_busy_s"] += seconds
                batch["enqueue_s"] += enqueue_s
                batch["block_s"] += block_s
            if len(batch["timeline"]) < _TIMELINE_CAP:
                event = {
                    "kernel": kernel,
                    "shape": shape,
                    "enqueue_s": round(enqueue_s, 6),
                    "block_s": round(block_s, 6),
                    "self_s": round(seconds, 6),
                    "fenced": fenced,
                }
                if compiled:
                    event["compiled"] = True
                if aot:
                    event["aot"] = True
                batch["timeline"].append(event)
        with self._lock:
            k = self._kernels.get(kernel)
            if k is None:
                k = self._kernels[kernel] = _Kernel(kernel)
            phase = override or ("steady" if self._sealed else "warmup")
            k.dispatches += 1
            k.phases[phase] += 1
            s = k.shapes.get(shape)
            if s is None:
                s = k.shapes[shape] = _Shape()
            s.dispatches += 1
            s.phases[phase] += 1
            if aot:
                k.aot_served += 1
                s.aot_served += 1
            if compiled:
                k.compiles += 1
                k.compile_s += seconds
                s.compiles += 1
                # a compile under a phase override (the AOT warm-start walk)
                # is prepayment, not a steady-state contract violation
                if self._sealed and override is None:
                    recompiled = True
                    k.recompiles += 1
                    self._recompile_events.append(
                        {"kernel": kernel, "shape": shape}
                    )
                    del self._recompile_events[:-50]
                    cbs = tuple(self._recompile_cbs.values())
            elif fenced:
                k.execute_s += seconds
                s.fenced += 1
                s.execute_s += seconds
                s.max_s = max(s.max_s, seconds)
                s.enqueue_s += enqueue_s
                s.block_s += block_s
        # metrics + callbacks outside the registry lock (they take their own)
        _DISPATCHES.inc({"kernel": kernel, "phase": phase})
        if compiled:
            _COMPILES.inc({"kernel": kernel, "phase": phase})
            _COMPILE_WALL.observe(seconds, {"kernel": kernel})
            if recompiled:
                _RECOMPILES.inc({"kernel": kernel})
                for cb in cbs:
                    try:
                        cb(kernel, shape)
                    except Exception:  # noqa: BLE001 — observers never break dispatch
                        pass
        elif fenced:
            _EXECUTE_WALL.observe(seconds, {"kernel": kernel, "bucket": shape})

    def record_host(self, kernel: str, shape: str) -> None:
        """A host-twin run of a device-parity kernel (small cube under the
        RTT threshold): counted so shape-bucket telemetry covers BOTH sides
        of the routing decision; host twins never compile. A host twin
        inside a batch scope marks the batch (host_records) but NEVER
        counts as a device dispatch or device-busy time — the efficiency
        timeline's regression contract."""
        batch = _BATCH.get()
        if batch is not None:
            batch["host_records"] += 1
        with self._lock:
            k = self._kernels.get(kernel)
            if k is None:
                k = self._kernels[kernel] = _Kernel(kernel)
            k.host_dispatches += 1
            s = k.shapes.get(shape)
            if s is None:
                s = k.shapes[shape] = _Shape()
            s.phases["host"] += 1
        _DISPATCHES.inc({"kernel": kernel, "phase": "host"})

    def steady_recompiles(self) -> int:
        with self._lock:
            return sum(k.recompiles for k in self._kernels.values())

    def efficiency_counters(self) -> dict:
        """Cumulative steady-batch efficiency counters (batch/dispatch
        counts + wall sums); the sim snapshots these at run start and
        reports the delta (observability/efficiency.report_section)."""
        with self._lock:
            return dict(self._eff)

    def execute_stats(self) -> dict:
        """Per-(kernel, shape bucket) fenced execute measurements — the
        measured side of the utilization ratio (cost-model floor ÷ mean
        execute wall)."""
        with self._lock:
            return {
                name: {
                    shape: {
                        "fenced": s.fenced,
                        "execute_s": s.execute_s,
                        "max_s": s.max_s,
                        "dispatches": s.dispatches,
                    }
                    for shape, s in k.shapes.items()
                }
                for name, k in self._kernels.items()
            }

    # -- snapshots -----------------------------------------------------------

    def counts_snapshot(self) -> dict:
        """The DETERMINISTIC counts: per (kernel, shape bucket) dispatch
        counts by phase, plus recompiles. Everything here is a pure function
        of the dispatched work (no walls, no jit-cache history), so two
        same-seed sim runs produce identical deltas."""
        with self._lock:
            return {
                name: {
                    "shapes": {
                        shape: dict(s.phases)
                        for shape, s in k.shapes.items()
                    },
                    "recompiles": k.recompiles,
                }
                for name, k in self._kernels.items()
            }

    def report(self, baseline: dict) -> dict:
        """The sim's ``report["kernels"]`` section: the counts delta since
        `baseline` (a prior counts_snapshot), digested. ONLY deterministic
        facts appear — wall splits and jit-cache compile counts are process
        history (a warm process legitimately skips a cold one's compiles)
        and live on /debug/kernels instead, the same split the sim applies
        to solverd's last_batch_seconds."""
        now = self.counts_snapshot()
        kernels_out: dict[str, dict] = {}
        recompiles = 0
        for name in sorted(now):
            cur = now[name]
            base = baseline.get(name, {})
            base_shapes = base.get("shapes", {})
            shapes_out: dict[str, dict] = {}
            totals = {ph: 0 for ph in _PHASES}
            for shape in sorted(cur["shapes"]):
                b = base_shapes.get(shape, {})
                delta = {
                    ph: cur["shapes"][shape][ph] - b.get(ph, 0)
                    for ph in _PHASES
                }
                if any(delta.values()):
                    shapes_out[shape] = {
                        ph: v for ph, v in delta.items() if v
                    }
                    for ph, v in delta.items():
                        totals[ph] += v
            if shapes_out:
                kernels_out[name] = {
                    "dispatches": (
                        totals["warmup"] + totals["steady"] + totals["aot-warm"]
                    ),
                    "host_dispatches": totals["host"],
                    "phases": {
                        "warmup": totals["warmup"],
                        "steady": totals["steady"],
                        "aot-warm": totals["aot-warm"],
                    },
                    "shapes": shapes_out,
                }
            recompiles += cur["recompiles"] - base.get("recompiles", 0)
        deterministic = {
            "kernels": kernels_out,
            "steady_recompiles": recompiles,
        }
        digest = hashlib.sha256(
            json.dumps(deterministic, sort_keys=True).encode()
        ).hexdigest()
        out = dict(deterministic)
        out["digest"] = digest
        return out

    def debug_snapshot(
        self, kernel: Optional[str] = None, view: Optional[str] = None
    ) -> Optional[dict]:
        """/debug/kernels: the per-kernel table, a single kernel's
        per-shape drill-down (None for an unknown kernel → 404), or one of
        the views — "ladder" (AOT ladder vs observed buckets), "cost"
        (cost-model tables joined with measured walls + utilization,
        ?kernel= drill-down), "timeline" (recent per-batch dispatch
        timelines with host-stall attribution), "delta" (incremental-solve
        residencies: warm/miss counters, resident bytes, miss reasons)."""
        if view == "ladder":
            from karpenter_tpu_torch.aot import runtime as aotrt

            return aotrt.ladder_view()
        if view == "cost":
            from karpenter_tpu_torch.observability import efficiency

            return efficiency.cost_view(kernel=kernel)
        if view == "delta":
            from karpenter_tpu_torch.ops import delta

            return delta.debug_view()
        if view == "timeline":
            with self._lock:
                recent = [dict(b) for b in self._batches[-16:]]
                eff = dict(self._eff)
            steady = {
                "steady_batches": eff["steady_batches"],
                "device_batches": eff["device_batches"],
                "host_only_batches": eff["host_only_batches"],
                "device_dispatches": eff["device_dispatches"],
                "device_busy_s": round(eff["busy_s"], 6),
                "host_gap_s": round(eff["gap_s"], 6),
                "wall_s": round(eff["wall_s"], 6),
                "host_stall_fraction": (
                    round(min(1.0, max(0.0, eff["gap_s"] / eff["wall_s"])), 6)
                    if eff["wall_s"] > 0
                    else None
                ),
            }
            return {"steady": steady, "batches": recent}
        with self._lock:
            if kernel is not None:
                k = self._kernels.get(kernel)
                if k is None:
                    return None
                shapes = [
                    {
                        "shape": shape,
                        "dispatches": s.dispatches,
                        "compiles": s.compiles,
                        "aot_served": s.aot_served,
                        "phases": dict(s.phases),
                        "execute_wall_s": round(s.execute_s, 6),
                        "mean_execute_s": round(s.execute_s / s.fenced, 6)
                        if s.fenced
                        else None,
                        "max_execute_s": round(s.max_s, 6),
                        "enqueue_wall_s": round(s.enqueue_s, 6),
                        "block_wall_s": round(s.block_s, 6),
                    }
                    for shape, s in k.shapes.items()
                ]
                # slowest buckets first: this ordering IS the AOT-ladder view
                shapes.sort(key=lambda d: (-(d["max_execute_s"] or 0.0), d["shape"]))
                return {
                    "kernel": k.name,
                    "dispatches": k.dispatches,
                    "host_dispatches": k.host_dispatches,
                    "compiles": k.compiles,
                    "cache_hits": k.dispatches - k.compiles,
                    "aot_served": k.aot_served,
                    "recompiles": k.recompiles,
                    "phases": dict(k.phases),
                    "compile_wall_s": round(k.compile_s, 6),
                    "execute_wall_s": round(k.execute_s, 6),
                    "shapes": shapes,
                }
            table = [
                {
                    "kernel": k.name,
                    "dispatches": k.dispatches,
                    "host_dispatches": k.host_dispatches,
                    "compiles": k.compiles,
                    "cache_hits": k.dispatches - k.compiles,
                    "aot_served": k.aot_served,
                    "recompiles": k.recompiles,
                    "phases": dict(k.phases),
                    "compile_wall_s": round(k.compile_s, 6),
                    "execute_wall_s": round(k.execute_s, 6),
                    "shapes_seen": len(k.shapes),
                }
                for k in self._kernels.values()
            ]
            table.sort(key=lambda d: (-d["execute_wall_s"], d["kernel"]))
            # the per-dispatch timelines live on view=timeline; the plain
            # table's batch ring stays the lean one-dispatch proof surface
            recent = [
                {k: v for k, v in b.items() if k != "timeline"}
                for b in self._batches[-16:]
            ]
            out = {
                "sealed": self._sealed,
                "phase": self.phase,
                "steady_recompiles": sum(
                    k.recompiles for k in self._kernels.values()
                ),
                "recompile_events": list(self._recompile_events),
                "device_memory": self._last_memory,
                # per-batch device dispatch counts (one-dispatch-solve
                # contract surface): cumulative per-kernel totals above
                # can't show whether ONE batch stayed at <=1 dispatch
                "batches": {
                    "last": recent[-1] if recent else None,
                    "recent": recent,
                },
                "kernels": table,
            }
        # AOT compile-service state (cache traffic, loaded executables,
        # off-ladder count) rides the same debug surface; taken outside the
        # registry lock — the runtime takes its own
        from karpenter_tpu_torch.aot import runtime as aotrt

        out["aot"] = aotrt.stats()
        return out


_REGISTRY = KernelRegistry()


def registry() -> KernelRegistry:
    return _REGISTRY


def reset_device_memory() -> None:
    """Engines were evicted or are being rebuilt: the per-device gauge
    series were sampled against the OLD engine's allocations and would
    otherwise persist as stale values until the next solve batch happens
    to resample them (PR 6 sampled per batch but never cleared). Drop the
    whole family and the cached /debug/kernels view; the first post-rebuild
    batch resamples fresh."""
    _DEVICE_MEM.clear()
    _LIVE_BYTES.set(0.0)
    with _REGISTRY._lock:
        _REGISTRY._last_memory = None


def sample_device_memory() -> dict:
    """Live bytes + per-device allocator stats, pushed into the gauges and
    cached on the registry for /debug/kernels. The port reads torch's CUDA
    caching allocator, per visible device: ``live_array_bytes`` is the sum
    of ``torch.cuda.memory_allocated(d)``, ``live_arrays`` the sum of the
    allocator's live blocks (``active.all.current`` of
    ``torch.cuda.memory_stats(d)``: blocks, not tensors — views share one),
    and each device's ``bytes_in_use`` / ``peak_bytes_in_use`` are that
    dict's ``allocated_bytes.all.current`` / ``.peak``, ``bytes_limit``
    ``torch.cuda.mem_get_info(d)[1]``. A device whose allocator never held
    memory is skipped (reading its limit would open a context on it). A
    no-op shell unless CUDA is already initialized — telemetry must not be
    the thing that initializes the card."""
    out: dict = {"live_array_bytes": 0, "live_arrays": 0, "devices": []}
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        try:
            total = count = 0
            for i in range(torch.cuda.device_count()):
                d = torch.device("cuda", i)
                stats = torch.cuda.memory_stats(d)
                if not stats.get("reserved_bytes.all.peak"):
                    continue
                total += int(torch.cuda.memory_allocated(d))
                count += int(stats.get("active.all.current", 0))
                entry: dict = {"device": str(d)}
                for stat, value in (
                    ("bytes_in_use", stats.get("allocated_bytes.all.current")),
                    ("peak_bytes_in_use", stats.get("allocated_bytes.all.peak")),
                    ("bytes_limit", torch.cuda.mem_get_info(d)[1]),
                ):
                    if value is not None:
                        entry[stat] = int(value)
                        _DEVICE_MEM.set(
                            float(value), {"device": str(d), "stat": stat}
                        )
                out["devices"].append(entry)
            out["live_array_bytes"] = total
            out["live_arrays"] = count
            _LIVE_BYTES.set(float(total))
        except Exception:  # noqa: BLE001 — sampling must never break a solve
            pass
    with _REGISTRY._lock:
        _REGISTRY._last_memory = out
    return out
