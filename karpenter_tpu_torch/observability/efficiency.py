"""The solver efficiency observatory: HLO cost models, host-stall
attribution, and triggered device profiling.

PR 6's kernel observatory says *what* dispatched and how long it took;
this layer says how fast a solve *should* have been and where the wall
actually went — the turnkey instrument both ROADMAP residuals ("measure
on real hardware") read their numbers from. Three legs:

**Cost tables.** At AOT warm start every (kernel, bucket, scope)
executable runs ``compiled.cost_analysis()`` (and ``memory_analysis()``
where the backend provides it) ONCE, producing flops / bytes-accessed /
roofline-floor-seconds tables keyed exactly like the runtime executable
table and cached as sidecar JSON alongside the persistent executable
cache. The observatory's per-bucket execute histograms then yield a
**utilization ratio** (cost-model floor ÷ measured wall) per rung —
``karpenter_kernel_utilization{kernel,bucket}`` and the
``/debug/kernels?view=cost`` drill-down. Cost-model numbers vary by
jaxlib/backend, so they live OUTSIDE every deterministic digest (the
same discipline as the AOT report section).

**Host-stall attribution.** ``tracing/kernel.dispatch`` splits enqueue
wall from block-until-ready wall, and the KernelRegistry's batch scope
reconstructs a per-batch timeline (device-busy vs host-gap), producing a
``host_stall_fraction`` per steady batch — the direct instrument for the
"host-paced conversation" claim. Surfaced on
``/debug/kernels?view=timeline``, per-solve spans (volatile attrs), and
the sim's ``report["kernels"]["efficiency"]`` section. A batch with zero
device dispatches is fully host-paced (fraction exactly 1.0 — a
deterministic fact); measured fractions on device-dispatching batches
are wall-clock and stay out of the digests.

**Triggered device profiling.** ``jax.profiler`` trace capture behind
``--profile-dir``: on demand (``/debug/profile/device?seconds=``) and
automatically armed by the SLO breach pipeline, so a breach's flight
bundle records the path of a captured device profile. Per-trigger
cooldown, unwritable dirs degrade to an in-memory warning, and nothing
in this module may ever fail a pass or a boot.

Graceful degradation everywhere: backends whose executables lack
``cost_analysis`` (or return nothing usable) and processes without a
working ``jax.profiler`` degrade to a once-per-boot warning and absent
tables — boot, warm start, and the observatory seal are never affected.

On the card (this package): the roofline peaks are one H100 row, found by
``torch.cuda.get_device_name`` once CUDA is initialized, and the profiler
service captures with ``torch.profiler`` (CPU activity, plus CUDA activity
when a card is present), writing a Chrome trace (``trace.json``) into each
capture's directory. Cost tables stay empty until an AOT warm start feeds
them (``note_executable``), which this package does not have yet.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time
from typing import Callable, Optional

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator import logging as klog
from karpenter_tpu_torch.utils.clock import Clock

_log = klog.logger("efficiency")

_UTILIZATION = global_registry.gauge(
    "karpenter_kernel_utilization",
    "cost-model floor seconds / measured mean execute seconds per "
    "(kernel, padded-shape bucket): the fraction of the XLA roofline the "
    "steady executable actually achieves (cost-model side varies by "
    "jaxlib/backend; never digested)",
    labels=["kernel", "bucket"],
)
_CAPTURES = global_registry.counter(
    "karpenter_profiler_captures_total",
    "device profile captures written under --profile-dir, by trigger",
    labels=["trigger"],
)
_CAPTURE_ERRORS = global_registry.counter(
    "karpenter_profiler_capture_errors_total",
    "device profile captures that failed (profiler unavailable, "
    "unwritable dir, backend refusal) — degraded, never raised",
)
_COST_ENTRIES = global_registry.gauge(
    "karpenter_kernel_cost_entries",
    "cost-model table entries built from compiled executables",
)

# minimum virtual seconds between breach-armed captures sharing a trigger
# (mirrors flight.DUMP_COOLDOWN: a burning objective must not start one
# device trace per pass)
CAPTURE_COOLDOWN = 60.0
# hard ceiling on a single capture's wall duration
MAX_CAPTURE_SECONDS = 30.0
# wall seconds a breach-armed background capture records before stopping
ARMED_CAPTURE_SECONDS = 0.25


# -- roofline model -----------------------------------------------------------

# (device name substring, peak operations/s, peak memory bytes/s). The
# floor is the classic roofline max(operations/peak, bytes/peak_bw). One
# row, the card this package runs on, with the rates PERF.md's bounds use:
# 16.73e12 32-bit integer/logic operations a second (64 a clock an SM x
# 132 SMs x 1.98 GHz; CUDA C++ Programming Guide, compute capability 9.0)
# and 3.35e12 bytes a second of HBM3 (NVIDIA H100 SXM data sheet) — the
# kernels here are integer and boolean work. The host default is
# deliberately conservative: utilization is a *comparative* instrument.
# Override with KARPENTER_TPU_PEAK_FLOPS / KARPENTER_TPU_PEAK_BYTES when
# calibrated.
DEVICE_PEAKS = (
    ("h100", 16.73e12, 3.35e12),
)
DEFAULT_PEAKS = (5e10, 2e10)  # generic host CPU core


def _parse_peak(raw: Optional[str], default: float) -> float:
    """Env override parse that can never crash a boot: a malformed value
    falls back to the device-kind default (the module's never-fail
    contract covers bad operator input too)."""
    if not raw:
        return default
    try:
        value = float(raw)
    except ValueError:
        return default
    return value if value > 0 else default


def _device_peaks() -> tuple[float, float]:
    """(peak operations/s, peak bytes/s) for the current CUDA device's
    name, env-overridable. Never initializes CUDA: without an initialized
    card the host default serves."""
    flops = os.environ.get("KARPENTER_TPU_PEAK_FLOPS")
    bw = os.environ.get("KARPENTER_TPU_PEAK_BYTES")
    kind = ""
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            kind = torch.cuda.get_device_name().lower()
    except Exception:  # noqa: BLE001 — no usable backend
        kind = ""
    pf, pb = DEFAULT_PEAKS
    for sub, kind_pf, kind_pb in DEVICE_PEAKS:
        if sub in kind:
            pf, pb = kind_pf, kind_pb
            break
    return _parse_peak(flops, pf), _parse_peak(bw, pb)


def _extract_cost(exe) -> dict:
    """Pull flops / bytes-accessed / memory stats off a compiled (or
    deserialized-and-loaded) executable. Raises when the backend provides
    nothing usable — the caller records the degradation."""
    ca = exe.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    if not isinstance(ca, dict):
        raise TypeError(f"cost_analysis returned {type(ca).__name__}")
    out: dict = {}
    if "flops" in ca:
        out["flops"] = float(ca["flops"])
    if "bytes accessed" in ca:
        out["bytes_accessed"] = float(ca["bytes accessed"])
    if "transcendentals" in ca and ca["transcendentals"]:
        out["transcendentals"] = float(ca["transcendentals"])
    try:
        ma = exe.memory_analysis()
        for attr, key in (
            ("argument_size_in_bytes", "argument_bytes"),
            ("output_size_in_bytes", "output_bytes"),
            ("temp_size_in_bytes", "temp_bytes"),
        ):
            v = getattr(ma, attr, None)
            if v is not None:
                out[key] = int(v)
    except Exception:  # noqa: BLE001 — memory analysis is optional everywhere
        pass
    if not out:
        raise ValueError("cost_analysis returned no usable fields")
    return out


def _floor_seconds(cost: dict) -> Optional[float]:
    """Roofline floor: the executable can finish no faster than its flops
    at peak compute or its bytes at peak bandwidth, whichever binds."""
    pf, pb = _device_peaks()
    terms = []
    if cost.get("flops"):
        terms.append(cost["flops"] / pf)
    if cost.get("bytes_accessed"):
        terms.append(cost["bytes_accessed"] / pb)
    return max(terms) if terms else None


# -- cost tables --------------------------------------------------------------


_COST_SUFFIX = ".cost.json"


class CostTables:
    """Process-global per-(kernel, bucket sig, scope) cost-model table,
    built exactly once per executable at AOT warm start (the perf floor
    asserts zero per-pass ``cost_analysis`` calls). Keys mirror the
    runtime executable table; sidecar JSON entries ride the persistent
    executable cache dir under the same content key."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables: dict[tuple, dict] = {}
        # scope-blind (kernel, sig) index: lookup() runs per shape after
        # every solverd batch (publish_utilization), so it must not scan
        # the full table
        self._by_pair: dict[tuple, dict] = {}
        self._failed: set[tuple] = set()
        self.analysis_calls = 0  # the perf-floor counter
        self.errors = 0
        self._warned_backend = False

    # -- building ------------------------------------------------------------

    def note_executable(
        self,
        kernel: str,
        sig: str,
        exe,
        scope: str = "",
        cache=None,
        key: Optional[str] = None,
    ) -> Optional[dict]:
        """Record one executable's cost model. Idempotent per (kernel,
        sig, scope) — a second engine warm-starting the same bucket pays
        nothing. Never raises: a backend without (or with a broken)
        ``cost_analysis`` degrades to a once-per-boot warning and an
        absent entry."""
        tkey = (kernel, sig, scope)
        with self._lock:
            if tkey in self._tables:
                return self._tables[tkey]
            if tkey in self._failed:
                return None
        entry = self._load_sidecar(cache, key)
        if entry is None:
            try:
                with self._lock:
                    self.analysis_calls += 1
                cost = _extract_cost(exe)
            except Exception as e:  # noqa: BLE001 — cost models are optional
                with self._lock:
                    self.errors += 1
                    self._failed.add(tkey)
                    warn = not self._warned_backend
                    self._warned_backend = True
                if warn:
                    _log.warning(
                        "backend provides no usable cost_analysis; "
                        "utilization ratios degrade to absent "
                        "(/debug/kernels?view=cost stays empty)",
                        kernel=kernel, shape=sig,
                        error=f"{type(e).__name__}: {e}",
                    )
                return None
            entry = dict(cost)
            entry["floor_s"] = _floor_seconds(cost)
            self._write_sidecar(cache, key, entry)
        with self._lock:
            self._tables[tkey] = entry
            self._by_pair.setdefault((kernel, sig), entry)
            n = len(self._tables)
        _COST_ENTRIES.set(float(n))
        return entry

    @staticmethod
    def _load_sidecar(cache, key: Optional[str]) -> Optional[dict]:
        root = getattr(cache, "root", None)
        if not root or not key:
            return None
        try:
            with open(
                os.path.join(root, key + _COST_SUFFIX), encoding="utf-8"
            ) as f:
                entry = json.load(f)
            return entry if isinstance(entry, dict) and entry else None
        except Exception:  # noqa: BLE001 — absent/corrupt sidecar = recompute
            return None

    @staticmethod
    def _write_sidecar(cache, key: Optional[str], entry: dict) -> None:
        root = getattr(cache, "root", None)
        if not root or not key:
            return
        try:
            path = os.path.join(root, key + _COST_SUFFIX)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(entry, f, sort_keys=True)
            os.replace(tmp, path)
        except OSError:
            # same discipline as the executable cache: a read-only dir
            # degrades to recomputing next boot, never crashes this one
            pass

    # -- queries -------------------------------------------------------------

    def lookup(self, kernel: str, sig: str) -> Optional[dict]:
        """Scope-blind lookup: the observatory's shape telemetry is
        deliberately scope-free (kernel digests stay mesh-invariant), so
        utilization joins on (kernel, sig) and any scope's cost model
        serves — sharded twins of one bucket cost the same by design."""
        with self._lock:
            return self._by_pair.get((kernel, sig))

    def table(self) -> list[dict]:
        with self._lock:
            rows = [
                {"kernel": k, "bucket": s, **({"scope": sc} if sc else {}), **e}
                for (k, s, sc), e in self._tables.items()
            ]
        rows.sort(key=lambda r: (r["kernel"], r["bucket"], r.get("scope", "")))
        return rows

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._tables),
                "analysis_calls": self.analysis_calls,
                "errors": self.errors,
            }

    def reset(self) -> None:
        """Tests only."""
        with self._lock:
            self._tables.clear()
            self._by_pair.clear()
            self._failed.clear()
            self.analysis_calls = 0
            self.errors = 0
            self._warned_backend = False
        _COST_ENTRIES.set(0.0)


_TABLES = CostTables()


def tables() -> CostTables:
    return _TABLES


def note_executable(
    kernel: str, sig: str, exe, scope: str = "", cache=None,
    key: Optional[str] = None,
) -> Optional[dict]:
    return _TABLES.note_executable(
        kernel, sig, exe, scope=scope, cache=cache, key=key
    )


# -- utilization --------------------------------------------------------------


def utilization_view() -> dict:
    """Per-(kernel, bucket) utilization ratios: cost-model floor ÷
    measured mean execute wall, for every bucket that has BOTH a cost
    entry and fenced execute measurements. {} when either side is absent
    (no AOT warm start, or a backend without cost models)."""
    from karpenter_tpu_torch.observability import kernels as kobs

    stats = kobs.registry().execute_stats()
    out: dict = {}
    for kernel, shapes in stats.items():
        for shape, s in shapes.items():
            if not s["fenced"] or s["execute_s"] <= 0:
                continue
            entry = _TABLES.lookup(kernel, shape)
            if entry is None or not entry.get("floor_s"):
                continue
            mean = s["execute_s"] / s["fenced"]
            out.setdefault(kernel, {})[shape] = {
                "floor_s": round(entry["floor_s"], 9),
                "mean_execute_s": round(mean, 9),
                "utilization": round(entry["floor_s"] / mean, 6),
                "samples": s["fenced"],
            }
    return out


def publish_utilization() -> dict:
    """Push the current ratios into ``karpenter_kernel_utilization``;
    called from the solverd post-batch telemetry hook (best-effort, never
    fails a batch). Returns the view it published."""
    view = utilization_view()
    for kernel, shapes in view.items():
        for shape, row in shapes.items():
            _UTILIZATION.set(
                row["utilization"], {"kernel": kernel, "bucket": shape}
            )
    return view


def cost_view(kernel: Optional[str] = None) -> Optional[dict]:
    """``/debug/kernels?view=cost``: the cost-model table joined with the
    observatory's measured execute stats. With ``kernel=`` the drill-down
    is restricted to that kernel (None — a 404 — when the kernel is
    known to neither side)."""
    from karpenter_tpu_torch.observability import kernels as kobs

    stats = kobs.registry().execute_stats()
    ratios = utilization_view()
    rows = []
    known = set(stats)
    for row in _TABLES.table():
        known.add(row["kernel"])
        if kernel is not None and row["kernel"] != kernel:
            continue
        measured = ratios.get(row["kernel"], {}).get(row["bucket"])
        out = dict(row)
        if measured:
            out.update(
                mean_execute_s=measured["mean_execute_s"],
                utilization=measured["utilization"],
                samples=measured["samples"],
            )
        rows.append(out)
    if kernel is not None and kernel not in known:
        return None
    pf, pb = _device_peaks()
    return {
        "peak_flops_per_s": pf,
        "peak_bytes_per_s": pb,
        "cost_tables": _TABLES.stats(),
        "rows": rows,
    }


# -- triggered device profiling -----------------------------------------------


def _slug(text: str) -> str:
    return re.sub(r"[^A-Za-z0-9]+", "-", text).strip("-").lower() or "capture"


class DeviceProfiler:
    """Process-global ``torch.profiler`` capture service behind
    ``--profile-dir`` (module accessor: ``profiler()``). Disabled (no
    dir) it answers None everywhere — the serving layer turns that into
    a 404. Captures are named by a per-process sequence
    (``device-0001-<trigger>``) so same-seed sim runs arm identically
    named captures; the wall-clock capture itself is a side effect,
    never a report fact."""

    def __init__(self, clock: Optional[Clock] = None, profile_dir: str = ""):
        self._lock = threading.Lock()
        self.clock = clock or Clock()
        self.profile_dir = profile_dir
        self._seq = 0  # reservations (names the sessions deterministically)
        self._completed = 0  # captures that actually stopped cleanly
        self._active = False
        self._last: dict[str, float] = {}
        self._recent: list[dict] = []
        self._available: Optional[bool] = None
        self._warned_unavailable = False
        self._warned_unwritable = False

    def configure(
        self,
        clock: Optional[Clock] = None,
        profile_dir: Optional[str] = None,
    ) -> "DeviceProfiler":
        with self._lock:
            if clock is not None:
                self.clock = clock
            if profile_dir is not None:
                self.profile_dir = profile_dir
        return self

    def reset(self) -> None:
        """Sim run start / tests: sequence, cooldowns, and the recent list
        restart so capture names are a pure function of the run."""
        with self._lock:
            self._seq = 0
            self._completed = 0
            self._last.clear()
            self._recent.clear()

    # -- availability --------------------------------------------------------

    def available(self) -> bool:
        """Is ``torch.profiler`` importable with a profile API? Cached; the
        first failure logs one warning and the profiler stays off —
        never checked again this boot. ``activities()`` says what a
        capture records: CUDA activity whenever a card is present."""
        with self._lock:
            if self._available is not None:
                return self._available
        ok = False
        err = ""
        try:
            from torch import profiler as _p  # noqa: F401

            ok = hasattr(_p, "profile") and hasattr(_p, "ProfilerActivity")
            if not ok:
                err = "torch.profiler has no profile/ProfilerActivity"
        except Exception as e:  # noqa: BLE001 — degraded, never fatal
            err = f"{type(e).__name__}: {e}"
        with self._lock:
            self._available = ok
            warn = not ok and not self._warned_unavailable
            self._warned_unavailable = self._warned_unavailable or not ok
        if warn:
            _log.warning(
                "torch.profiler unavailable; device profile capture disabled "
                "(--profile-dir has no effect)",
                error=err,
            )
        return ok

    @staticmethod
    def activities() -> list:
        """The activities a capture records, by name: "cpu", and "cuda"
        when a card is present."""
        import torch

        return ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])

    @property
    def enabled(self) -> bool:
        return bool(self.profile_dir) and self.available()

    # -- capture -------------------------------------------------------------

    def _reserve(self, trigger: str) -> Optional[dict]:
        """Reserve the (single) capture slot and the session dir. Returns
        the capture record, or None (disabled / busy / unwritable). Does
        NOT start the trace — ``_run`` does, so start and stop always
        execute on the same thread (the profiler's session has thread
        affinity; splitting start/stop across threads can deadlock the
        python tracer under GIL contention)."""
        if not self.enabled:
            return None
        with self._lock:
            if self._active:
                return None
            self._active = True
            self._seq += 1
            name = f"device-{self._seq:04d}-{_slug(trigger)}"
        path = os.path.join(self.profile_dir, name)
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            with self._lock:
                self._active = False
                warn = not self._warned_unwritable
                self._warned_unwritable = True
            _CAPTURE_ERRORS.inc()
            if warn:
                _log.warning(
                    "device profile dir unwritable; captures degrade to "
                    "warnings",
                    path=path, error=f"{type(e).__name__}: {e}",
                )
            return None
        return {"name": name, "path": path, "trigger": trigger}

    def _run(self, record: dict) -> None:
        """One whole capture — start, wait, stop, export the Chrome trace
        to ``<path>/trace.json`` (``record["trace"]``) — on the CURRENT
        thread, then release the slot. Never raises."""
        try:
            from torch import profiler as tprof

            prof = tprof.profile(
                activities=[
                    getattr(tprof.ProfilerActivity, name.upper())
                    for name in self.activities()
                ]
            )
            prof.start()
            try:
                if record["seconds"]:
                    time.sleep(record["seconds"])
            finally:
                prof.stop()
            trace = os.path.join(record["path"], "trace.json")
            prof.export_chrome_trace(trace)
            record["trace"] = trace
        except Exception as e:  # noqa: BLE001 — capture must never fail a pass
            _CAPTURE_ERRORS.inc()
            record["error"] = f"{type(e).__name__}: {e}"
        finally:
            with self._lock:
                self._active = False
                self._recent.append(
                    {k: v for k, v in record.items() if k != "pending"}
                )
                del self._recent[:-8]
        if "error" not in record:
            with self._lock:
                self._completed += 1
            _CAPTURES.inc({"trigger": record["trigger"]})

    def capture(self, seconds: float, trigger: str = "debug") -> Optional[dict]:
        """Synchronous capture (the ``/debug/profile/device`` handler
        blocks its serving thread, exactly like ``/debug/profile``):
        trace for `seconds` of wall time, then stop. Returns the capture
        record, None when profiling is disabled, or a record with an
        ``error`` when the capture slot is busy."""
        if not self.enabled:
            return None
        record = self._reserve(trigger)
        if record is None:
            # _reserve already counted an unwritable dir; a busy slot is
            # contention, not an error — neither path double-counts
            return {"error": "capture already in progress or dir unwritable"}
        record["seconds"] = min(max(seconds, 0.0), MAX_CAPTURE_SECONDS)
        self._run(record)
        return record

    def arm(
        self,
        trigger: str,
        seconds: float = ARMED_CAPTURE_SECONDS,
        cooldown: float = CAPTURE_COOLDOWN,
    ) -> Optional[dict]:
        """The breach pipeline's non-blocking capture: reserve the slot
        now, run the whole capture (start → `seconds` of WALL time → stop)
        on a worker thread, return the record immediately so the flight
        bundle can carry the path. Per-trigger cooldown on the injected
        clock (virtual seconds under a sim); None when disabled, cooling
        down, or already capturing."""
        now = self.clock.now()
        with self._lock:
            last = self._last.get(trigger)
            if last is not None and cooldown > 0 and now - last < cooldown:
                return None
        record = self._reserve(trigger)
        if record is None:
            return None
        with self._lock:
            self._last[trigger] = now
        record["seconds"] = min(max(seconds, 0.0), MAX_CAPTURE_SECONDS)
        record["pending"] = True
        # snapshot BEFORE the worker starts: it mutates `record` (error,
        # completion), and the returned copy is bound for the flight
        # bundle's context — which must be a pure function of the arm,
        # never of how far the capture got
        out = {k: v for k, v in record.items() if k != "pending"}
        # non-daemon: interpreter exit waits for the worker, so the capture
        # files are complete even when the process ends inside `seconds`
        worker = threading.Thread(
            target=self._run, args=(record,),
            name=f"karpenter-profiler-{record['name']}", daemon=False,
        )
        worker.start()
        return out

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> dict:
        # resolved BEFORE taking the lock: `enabled` runs available(),
        # which takes the same (non-reentrant) lock
        enabled = self.enabled
        with self._lock:
            return {
                "enabled": enabled,
                "profile_dir": self.profile_dir or None,
                # captures = sessions that STOPPED cleanly (matches the
                # karpenter_profiler_captures_total metric); reserved =
                # session names handed out (failures included)
                "captures": self._completed,
                "reserved": self._seq,
                "active": self._active,
                "recent": list(self._recent),
            }


_PROFILER = DeviceProfiler()


def profiler() -> DeviceProfiler:
    return _PROFILER


def configure_profiler(
    clock: Optional[Clock] = None, profile_dir: Optional[str] = None
) -> DeviceProfiler:
    return _PROFILER.configure(clock=clock, profile_dir=profile_dir)


# -- the sim report section ---------------------------------------------------


def snapshot_base() -> dict:
    """Run-start snapshot for ``report_section`` deltas (the same delta
    discipline as the kernels/aot sections — the counters are
    process-cumulative)."""
    from karpenter_tpu_torch.observability import kernels as kobs

    return {
        "eff": kobs.registry().efficiency_counters(),
        "cost_errors": _TABLES.stats()["errors"],
        "captures_armed": _PROFILER.snapshot()["reserved"],
    }


def report_section(base: Optional[dict] = None) -> dict:
    """``report["kernels"]["efficiency"]``: this run's steady-batch
    host-stall attribution plus the cost-model state. Rides OUTSIDE the
    kernels digest (cost models and measured walls vary by machine), but
    its *deterministic* facts — batch counts, dispatch counts, and the
    exact 1.0 fraction of fully host-paced runs — reproduce per seed, so
    full-report equality holds on scenarios that never device-dispatch."""
    from karpenter_tpu_torch.observability import kernels as kobs

    eff = kobs.registry().efficiency_counters()
    b = (base or {}).get("eff", {})
    d = {k: eff[k] - b.get(k, 0) for k in eff}
    batches = d["steady_batches"]
    if batches <= 0:
        fraction = None
    elif d["busy_s"] <= 0.0:
        # zero device-busy wall: every steady batch was host-paced end to
        # end — exactly 1.0, a deterministic fact (no division involved)
        fraction = 1.0
    else:
        fraction = round(
            min(1.0, max(0.0, d["gap_s"] / d["wall_s"])), 6
        ) if d["wall_s"] > 0 else None
    cost = _TABLES.stats()
    return {
        "steady_batches": batches,
        "device_batches": d["device_batches"],
        "host_only_batches": d["host_only_batches"],
        "steady_device_dispatches": d["device_dispatches"],
        "host_stall_fraction": fraction,
        # cost-model + utilization: machine facts, absent without an AOT
        # warm start (or on backends with no cost_analysis)
        "utilization": utilization_view(),
        "cost_tables": {
            "entries": cost["entries"],
            "errors": cost["errors"] - (base or {}).get("cost_errors", 0),
        },
        # capture SESSIONS ARMED this run (not completions — a still-
        # running 0.25s worker at finalize would make completion counts
        # wall-racy; whether later-breach arms land is wall-dependent
        # either way once --profile-dir is on, which is why the whole
        # section rides outside the digest)
        "profiler_captures_armed": (
            _PROFILER.snapshot()["reserved"]
            - (base or {}).get("captures_armed", 0)
        ),
    }
