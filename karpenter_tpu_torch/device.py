"""Device resolution and the CUDA kernel build.

Entry points of this package run on the card unless the caller asks for the
CPU: `resolve_device(None)` is the current CUDA device, and raises when CUDA
is absent. `device="cpu"` selects the plain torch versions of the kernels.

`build_kernels()` compiles every `csrc/*.cu` with nvcc for sm_90a into a
shared library with a plain C interface (one nvcc per source, all started
together) under `_build/`, keyed by a hash of the source and the shared
headers (`csrc/*.cuh`), and loads each with ctypes. It runs at first use
of a kernel; nothing is built when the package is imported. The AOT
compile service (aot/compiler.warm_start with a cache directory) points
the build at the cache's library directory for its walk
(`use_library_dir`), so a boot against a warm cache loads every library
and runs no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no a*b+c contraction: the fused scan's float64 results must round
    # exactly as the reference's separate operations do
    "--fmad=false",
    "-Xptxas", "-v",
)


class KernelError(RuntimeError):
    """A kernel failed to build or to launch, or the device work around it
    failed. Never caught on the solve path: the solve fails instead of
    falling back to the host loop, and the host loop does not record it as
    a pod's error."""


@contextlib.contextmanager
def device_work(what: str):
    """Raise every failure inside as a KernelError: a failed allocation or
    copy (torch.OutOfMemoryError), or a fault of an earlier launch that
    surfaces at the next synchronizing call (a RuntimeError or, in newer
    torch, torch.AcceleratorError), fails like a failed launch."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:
        raise KernelError(f"{what}: {type(e).__name__}: {e}") from e

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per source: nvcc's output (ptxas register/shared-memory report) and wall
# seconds of the build, for chip_smoke.py to print
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}
# libraries built or loaded in this process: the port's one compile.
# tracing/kernel.dispatch calls a dispatch during which it grew a compile
_built = 0
# nvcc processes this process has run (a library loaded from disk runs none)
_nvcc_runs = 0
# where libraries are built into and loaded from
_lib_dir = BUILD_DIR


def build_count() -> int:
    """How many kernel libraries this process has built or loaded."""
    return _built


def nvcc_runs() -> int:
    """How many nvcc builds this process has run."""
    return _nvcc_runs


@contextlib.contextmanager
def use_library_dir(path: str):
    """Build kernel libraries into, and load them from, `path` (the AOT
    compile cache's library directory) inside the block, and the build
    directory again after it. Libraries loaded inside stay loaded."""
    global _lib_dir
    with _lock:
        prev, _lib_dir = _lib_dir, path
    try:
        yield
    finally:
        with _lock:
            _lib_dir = prev


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: CUDA unless the caller asks
    for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "torch versions on the host"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> dict[str, str]:
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    }


def library_name(name: str, src: str) -> str:
    """The library's file name, keyed by its source, the headers beside it
    (csrc/*.cuh, which any source may include) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return f"lib{name}_{digest.hexdigest()[:16]}.so"


def _so_path(name: str, src: str) -> str:
    """The library's path in the build directory (`_build/`, or the AOT
    cache's library directory inside use_library_dir)."""
    return os.path.join(_lib_dir, library_name(name, src))


def build_kernels() -> dict[str, ctypes.CDLL]:
    """Compile (when not already built) and load every csrc/*.cu. Raises
    KernelError with nvcc's output when a build fails."""
    with _lock:
        todo = {n: s for n, s in _sources().items() if n not in _libs}
        if not todo:
            return dict(_libs)
        os.makedirs(_lib_dir, exist_ok=True)
        procs = {}
        for name, src in todo.items():
            so = _so_path(name, src)
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            procs[name] = (
                subprocess.Popen(
                    [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
                    stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT,
                ),
                tmp,
                so,
                time.perf_counter(),
            )
        global _built, _nvcc_runs
        _nvcc_runs += len(procs)
        failures = []
        for name, (proc, tmp, so, t0) in procs.items():
            out, _ = proc.communicate()
            BUILD_SECONDS[name] = time.perf_counter() - t0
            BUILD_LOG[name] = out.decode(errors="replace")
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exit {proc.returncode}\n{BUILD_LOG[name]}")
                if os.path.exists(tmp):
                    os.unlink(tmp)
                continue
            os.replace(tmp, so)
        if failures:
            raise KernelError("kernel build failed:\n" + "\n".join(failures))
        for name, src in todo.items():
            _libs[name] = ctypes.CDLL(_so_path(name, src))
            _built += 1
        return dict(_libs)


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<name>.cu (building on first use)."""
    lib = _libs.get(name)
    if lib is None:
        lib = build_kernels().get(name)
        if lib is None:
            raise KernelError(f"no kernel source csrc/{name}.cu")
    return lib


def launch(device: torch.device, entry, *args) -> int:
    """Call a kernel's C entry point with `device` the current CUDA device
    and the raw cudaStream_t of its current stream appended as the last
    argument; returns the entry point's cudaError. The kernels launch on
    the current device, so a launch for operands on another card (a mesh
    shard) switches to it first and switches back after; the wrapper has
    checked that every operand lives on `device`. The stream is read anew
    every call (torch's own raw-stream accessor, which honours
    `torch.cuda.stream(...)` contexts); nothing is cached between calls.
    Pointer arguments may be plain ints: the entry points declare them
    c_void_p."""
    idx = device.index
    C = torch._C
    if C._cuda_getDevice() == idx:
        return entry(*args, C._cuda_getCurrentRawStream(idx))
    prev = C._cuda_exchangeDevice(idx)
    try:
        return entry(*args, C._cuda_getCurrentRawStream(idx))
    finally:
        C._cuda_maybeExchangeDevice(prev)
