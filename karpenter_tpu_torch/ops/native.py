"""Build and load the native FFD steady-state kernel (ffd_kernel.cc).

The shared library is compiled on first use with the system C++ toolchain
and cached in the package's build directory (karpenter_tpu_torch/_build/),
keyed by a source hash — mirroring how the
reference ships a compiled scheduler core while we stay pip-less. Loading is
best-effort: any failure (no compiler, unwritable dir, exotic platform)
degrades to the pure-Python loop in ops/ffd.py, which computes identical
decisions — BUT it is ~100x slower in steady state, so the degradation is
ALERTED, not just counted: a warning log line fires here the moment the
fallback engages, and the provisioner publishes a Warning event
(NativeKernelUnavailable) so operators see it in the event stream.

Set KARPENTER_TPU_NATIVE=0 to force the Python loop (deliberate — no
alert). Set KARPENTER_TPU_CXX to pin (or poison, in tests) the compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "_native", "ffd_kernel.cc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_build_error: Optional[str] = None

i32, i64, u8, u64, f64 = (
    ctypes.c_int32,
    ctypes.c_int64,
    ctypes.c_uint8,
    ctypes.c_uint64,
    ctypes.c_double,
)
p_i32 = ctypes.POINTER(i32)
p_i64 = ctypes.POINTER(i64)
p_u8 = ctypes.POINTER(u8)
p_u64 = ctypes.POINTER(u64)
p_f64 = ctypes.POINTER(f64)
voidp = ctypes.c_void_p

ACT_DONE = 0
ACT_NEED_TOL = 1
ACT_NEED_JOIN = 2
ACT_NEED_NEW_CLAIM = 3
ACT_NEED_NODES = 4
ACT_TIMEOUT = 5

JOIN_REJECT = 1
JOIN_SAME = 2
JOIN_NARROW = 3


def _build() -> Optional[str]:
    global _build_error
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"ffd_kernel_{tag}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    override = os.environ.get("KARPENTER_TPU_CXX")
    compilers = (override,) if override else ("g++", "c++", "clang++")
    tmp = f"{so}.{os.getpid()}.tmp"  # unique per process: concurrent builders
    failures = []
    try:
        for cxx in compilers:
            try:
                r = subprocess.run(
                    [cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, _SRC],
                    capture_output=True,
                    timeout=120,
                )
            except (OSError, subprocess.TimeoutExpired) as e:
                failures.append(f"{cxx}: {e}")
                continue
            if r.returncode == 0:
                os.replace(tmp, so)
                return so
            failures.append(
                f"{cxx}: exit {r.returncode}: "
                f"{r.stderr.decode(errors='replace')[:200].strip()}"
            )
        _build_error = "; ".join(failures) or "no C++ compiler found"
        return None
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass


def _sigs(lib: ctypes.CDLL) -> None:
    lib.kt_new.restype = voidp
    lib.kt_new.argtypes = [
        i32, i32, i32, i32, i32, i32,
        p_i32, p_f64, p_f64, p_i32, p_i32, p_u64, u8, f64,
    ]
    lib.kt_free.argtypes = [voidp]
    lib.kt_set_tol.argtypes = [voidp, i32, i32, u8]
    lib.kt_set_join.argtypes = [voidp, i32, i32, ctypes.c_int8, i32, p_u64]
    lib.kt_add_claim.restype = i32
    lib.kt_add_claim.argtypes = [voidp, i32, i32, i32, i32, p_u64, p_i32, p_f64, i32]
    lib.kt_set_nodes_done.argtypes = [voidp, i32]
    lib.kt_resolve.argtypes = [voidp, i32]
    lib.kt_run.restype = ctypes.c_int
    lib.kt_run.argtypes = [voidp, p_i64]
    lib.kt_timed_out.restype = u8
    lib.kt_timed_out.argtypes = [voidp]
    lib.kt_head.restype = i64
    lib.kt_head.argtypes = [voidp]
    lib.kt_queue_len.restype = i64
    lib.kt_queue_len.argtypes = [voidp]
    lib.kt_queue_tail.argtypes = [voidp, i64, p_i32]
    lib.kt_failed.argtypes = [voidp, p_u8]
    lib.kt_num_claims.restype = i32
    lib.kt_num_claims.argtypes = [voidp]
    lib.kt_export_sizes.argtypes = [voidp, p_i64]
    lib.kt_export.argtypes = [voidp, p_i64, p_u64, p_i32, p_i32, p_i32, p_i32]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded kernel library, or None when unavailable/disabled."""
    global _lib, _tried, _build_error
    if os.environ.get("KARPENTER_TPU_NATIVE", "1") == "0":
        return None
    if _tried:
        return _lib
    with _lock:
        if _tried:
            return _lib
        try:
            so = _build()
            if so is not None:
                lib = ctypes.CDLL(so)
                _sigs(lib)
                _lib = lib
        except Exception as e:  # noqa: BLE001 — degrade to the Python loop
            _lib = None
            _build_error = _build_error or f"{type(e).__name__}: {e}"
        if _lib is None:
            if _build_error is None:
                _build_error = "native kernel build failed"
            # alert, don't just degrade: the pure-Python steady-state loop
            # is ~100x slower — operators must see this, not discover it
            # in a latency graph
            from karpenter_tpu_torch.operator import logging as klog

            klog.logger("native").warning(
                "native FFD kernel unavailable; scheduling falls back to "
                "the pure-Python steady-state loop (~100x slower)",
                error=_build_error,
            )
        _tried = True
    return _lib


def build_failure() -> Optional[str]:
    """Why the native kernel is unavailable (None when it loaded, was
    never tried, or was deliberately disabled via KARPENTER_TPU_NATIVE=0).
    The provisioner turns this into a Warning event once per process."""
    if os.environ.get("KARPENTER_TPU_NATIVE", "1") == "0":
        return None
    if not _tried or _lib is not None:
        return None
    return _build_error or "native kernel build failed"
