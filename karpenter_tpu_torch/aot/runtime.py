"""AOT runtime state: the executable table, active ladder/cache config,
and off-ladder accounting.

The executable table maps (kernel name, full shape signature) to a
warm-started executable (aot/compiler.Executable: a callable that checks
the operands' shapes and dtypes, then calls the kernel's wrapper).
`tracing/kernel.dispatch` consults it on every named dispatch: a hit calls
the executable directly — its kernel library built or loaded and its bucket
launched once at boot — which is what makes a warm-started daemon's first
solve run entirely on prepaid buckets. Signatures embed every array dim
(catalog dims included), so executables built for one catalog can never
serve another.

Off-ladder accounting: a device dispatch of a laddered kernel whose dims
exceed every configured bucket is counted
(``karpenter_aot_offladder_dispatches_total{kernel=}``), logged once per
(kernel, shape), and fired at registered callbacks — the provisioner
publishes an ``AOTOffLadderDispatch`` warning event. Off-ladder dispatches
still execute correctly (plain power-of-two padding, a lazy launch);
the warning is the ladder-tuning signal, and
``/debug/kernels?view=ladder`` is its drill-down.

This module must stay import-light: it is imported by the dispatch hot
path and by the observability layer.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.operator import logging as klog

from karpenter_tpu_torch.aot import ladder as ladder_mod
from karpenter_tpu_torch.aot.cache import ExecutableCache

_log = klog.logger("aot")

_OFF_LADDER = global_registry.counter(
    "karpenter_aot_offladder_dispatches_total",
    "device dispatches of laddered kernels whose shape missed every "
    "configured AOT bucket (each one jit-compiles a shape the warm start "
    "never prepaid); mesh labels the device layout of sharded dispatches "
    "('' = unsharded)",
    labels=["kernel", "mesh"],
)
_EXEC_FALLBACKS = global_registry.counter(
    "karpenter_aot_executable_fallbacks_total",
    "AOT executable invocations that failed and fell back to JIT",
    labels=["kernel"],
)

_lock = threading.Lock()
_LADDER: Optional[ladder_mod.Ladder] = None
_CACHE: Optional[ExecutableCache] = None
_EXECUTABLES: dict[tuple, object] = {}
_OFF_LADDER_EVENTS: list[dict] = []
_OFF_LADDER_COUNT = 0
_OFF_LADDER_SEEN: set[tuple] = set()
_OFF_LADDER_CBS: dict[str, Callable[[str, str], None]] = {}
_FRESH_COMPILES = 0
_WARM_STARTS = 0


# -- configuration ------------------------------------------------------------


def configure(
    ladder: Optional[ladder_mod.Ladder], cache: Optional[ExecutableCache]
) -> None:
    """Install the process's active ladder + cache (None/None disables AOT).
    Executables already loaded stay installed — they are keyed by full
    shape signature and remain correct regardless of configuration."""
    global _LADDER, _CACHE
    with _lock:
        _LADDER = ladder
        _CACHE = cache


def configure_from_options(options) -> None:
    """Operator/daemon boot: resolve --aot-ladder / --compile-cache-dir.
    A cache dir with no explicit ladder implies the default ladder (a
    persistent cache is pointless without buckets to fill it with)."""
    spec = getattr(options, "aot_ladder", "") or ""
    cache_dir = getattr(options, "compile_cache_dir", "") or ""
    if not spec and cache_dir:
        spec = "default"
    ladder = ladder_mod.resolve(spec)
    cache = ExecutableCache(cache_dir) if (ladder and cache_dir) else None
    configure(ladder, cache)


def enabled() -> bool:
    return _LADDER is not None


def active_ladder() -> Optional[ladder_mod.Ladder]:
    return _LADDER


def active_cache() -> Optional[ExecutableCache]:
    return _CACHE


# -- the executable table -----------------------------------------------------


def lookup(kernel: Optional[str], sig: Optional[str], scope: str = ""):
    """`scope` separates executables that share a (kernel, shape) identity
    but were compiled for different device layouts — a shard_mapped kernel's
    global shape is mesh-size-invariant by design (ladder.MESH_ALIGN), so
    the mesh shape must live in the TABLE key, never in the observatory's
    shape signature (kernel digests stay mesh-invariant)."""
    if kernel is None or not _EXECUTABLES:
        return None
    return _EXECUTABLES.get((kernel, sig, scope))


def install(kernel: str, sig: str, executable, scope: str = "") -> None:
    with _lock:
        _EXECUTABLES[(kernel, sig, scope)] = executable


def discard(
    kernel: str, sig: str, error: Optional[str] = None, scope: str = ""
) -> None:
    """An installed executable failed at call time (backend change, aval
    drift): drop it and count the fallback — dispatch re-runs through jit."""
    with _lock:
        _EXECUTABLES.pop((kernel, sig, scope), None)
    _EXEC_FALLBACKS.inc({"kernel": kernel})
    _log.warning(
        "AOT executable failed; falling back to JIT",
        kernel=kernel, shape=sig, scope=scope or None, error=error or "",
    )


def executables() -> list[dict]:
    with _lock:
        return [
            {"kernel": k, "shape": s, **({"scope": sc} if sc else {})}
            for (k, s, sc) in sorted(_EXECUTABLES)
        ]


def clear_executables() -> None:
    """Tests and restart legs: forget every loaded executable."""
    with _lock:
        _EXECUTABLES.clear()


def note_warm_start(fresh_compiles: int) -> None:
    global _FRESH_COMPILES, _WARM_STARTS
    with _lock:
        _FRESH_COMPILES += fresh_compiles
        _WARM_STARTS += 1


# -- off-ladder accounting ----------------------------------------------------


def on_off_ladder(cb: Callable[[str, str], None], key: str = "default") -> None:
    """Register a (kernel, shape) callback for off-ladder dispatches. Keyed
    replace semantics, like KernelRegistry.on_recompile."""
    with _lock:
        _OFF_LADDER_CBS[key] = cb


def note_off_ladder(kernel: str, shape: str, mesh: str = "") -> None:
    """`mesh` carries the device layout of a sharded dispatch (e.g.
    "mesh=8:pods"): it labels the counter and the event so a mis-sized
    ladder's warnings name WHICH mesh shape missed, not just the kernel."""
    global _OFF_LADDER_COUNT
    with _lock:
        _OFF_LADDER_COUNT += 1
        event = {"kernel": kernel, "shape": shape}
        if mesh:
            event["mesh"] = mesh
        _OFF_LADDER_EVENTS.append(event)
        del _OFF_LADDER_EVENTS[:-50]
        first = (kernel, shape, mesh) not in _OFF_LADDER_SEEN
        _OFF_LADDER_SEEN.add((kernel, shape, mesh))
        cbs = tuple(_OFF_LADDER_CBS.values())
    _OFF_LADDER.inc({"kernel": kernel, "mesh": mesh})
    if first:
        _log.warning(
            "dispatch missed the AOT bucket ladder; this shape jit-compiles "
            "instead of warm-starting — tune the ladder "
            "(/debug/kernels?view=ladder)",
            kernel=kernel, shape=shape, mesh=mesh or None,
        )
    # callbacks keep the 2-arg (kernel, shape) contract; a sharded
    # dispatch's shape carries the mesh so the published event names it
    cb_shape = f"{shape}@{mesh}" if mesh else shape
    for cb in cbs:
        try:
            cb(kernel, cb_shape)
        except Exception:  # noqa: BLE001 — observers never break dispatch
            pass


def reset_off_ladder() -> None:
    """Tests only."""
    global _OFF_LADDER_COUNT
    with _lock:
        _OFF_LADDER_COUNT = 0
        _OFF_LADDER_EVENTS.clear()
        _OFF_LADDER_SEEN.clear()
        _OFF_LADDER_CBS.clear()


# -- introspection ------------------------------------------------------------


def stats() -> dict:
    """Cumulative AOT state: cache traffic, loaded executables, off-ladder
    count. The sim snapshots this at run start and reports the delta.
    Cache traffic reads the PROCESS totals (aot/cache.totals), not the
    active instance, so deltas stay monotonic across re-configures."""
    from karpenter_tpu_torch.aot import cache as cache_mod

    cache_stats = cache_mod.totals()
    with _lock:
        return {
            "enabled": _LADDER is not None,
            "ladder_version": _LADDER.version if _LADDER else None,
            "executables_loaded": len(_EXECUTABLES),
            "warm_starts": _WARM_STARTS,
            "fresh_compiles": _FRESH_COMPILES,
            "off_ladder_dispatches": _OFF_LADDER_COUNT,
            "cache_hits": cache_stats["hits"],
            "cache_misses": cache_stats["misses"],
            "cache_evictions": cache_stats["evictions"],
            "cache_write_errors": cache_stats["write_errors"],
        }


_DELTA_KEYS = (
    "warm_starts",
    "fresh_compiles",
    "off_ladder_dispatches",
    "cache_hits",
    "cache_misses",
    "cache_evictions",
    "cache_write_errors",
)


def stats_delta(base: dict) -> dict:
    now = stats()
    out = {
        k: v for k, v in now.items() if k not in _DELTA_KEYS
    }
    for k in _DELTA_KEYS:
        out[k] = now[k] - base.get(k, 0)
    return out


def ladder_view() -> dict:
    """/debug/kernels?view=ladder: the configured ladder next to the
    observatory's observed shape buckets, flagging off-ladder dispatches —
    the drill-down data for tuning the ladder."""
    from karpenter_tpu_torch.observability import kernels as kobs

    ladder = _LADDER
    snap = kobs.registry().counts_snapshot()
    observed: dict[str, list] = {}
    with _lock:
        # on_ladder is a (kernel, shape) question — any scope's executable
        # (a mesh variant included) makes the observed bucket prepaid
        installed = {(k, s) for (k, s, _scope) in _EXECUTABLES}
        off_events = list(_OFF_LADDER_EVENTS)
        off_count = _OFF_LADDER_COUNT
    for name in sorted(snap):
        rows = []
        for shape, phases in sorted(snap[name]["shapes"].items()):
            device = bool(
                phases.get("warmup") or phases.get("steady")
                or phases.get("aot-warm")
            )
            row = {
                "shape": shape,
                "phases": {k: v for k, v in phases.items() if v},
            }
            if device and ladder is not None and name in ladder.kernels:
                row["on_ladder"] = (name, shape) in installed
            rows.append(row)
        observed[name] = rows
    return {
        "enabled": ladder is not None,
        "ladder_version": ladder.version if ladder else None,
        "ladder": ladder.to_dict()["kernels"] if ladder else {},
        "executables": executables(),
        "off_ladder": {"count": off_count, "events": off_events},
        "observed": observed,
        "cache": _CACHE.stats() if _CACHE is not None else None,
    }
