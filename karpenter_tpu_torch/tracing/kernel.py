"""Kernel wall-time attribution: compile vs execute, per solve — and the
instrumented-dispatch choke point feeding the kernel observatory.

The solve span wants to answer "was this solve slow because XLA compiled a
new executable, or because the device executed a big cube?" — the split
the ROADMAP's solver tuning needs. JAX exposes no per-dispatch hook, so the
attribution is structural: every device dispatch in the solver goes through
``dispatch()``, which fences with ``block_until_ready`` and classifies the
wall time by the jitted callable's compile-cache delta (a dispatch that
grew the cache paid a compile; one that didn't ran a warm executable).

Measurements accumulate into a contextvar-scoped dict opened by
``measure()`` (the solverd coalescer wraps each request's solve in one), so
nested dispatches attribute to the request that triggered them and
concurrent daemon threads never mix accounts. All numbers here are
wall-clock — span code must record them as VOLATILE attrs, never in the
deterministic digest.

Each dispatch's wall is additionally split into enqueue (the host-side
call: tracing, argument staging, nested dispatches, any compile) vs block
(the ``block_until_ready`` wait — device work the host demonstrably
waited on). The split feeds the efficiency observatory's per-batch
host-stall timeline (observability/efficiency.py); unfenced dispatches
report zero block wall because their device work was never awaited here.

Nesting: a fenced dispatch whose callable itself dispatches (a host driver
wrapping an inner kernel) attributes wall time to the INNERMOST dispatch
only — each frame subtracts its children's elapsed time before recording,
so the measure() totals and the registry's per-kernel walls never double
count one second of device work.

Named dispatches (``kernel="packer.solve_block"``) additionally report to
``observability/kernels.KernelRegistry``: compile counts, the padded input
shape signature, and the warmup/steady phase label — recorded even OUTSIDE
a measurement context (prewarm compiles must be attributed), but fenced
only when a context is open or a compile happened, so tracing-off hot
paths keep their async dispatch pipeline.

On the card (this package): the fence records one ``torch.cuda.Event`` on
the current stream of each device that holds a CUDA tensor among the
outputs (tuples and lists walked) and synchronizes it; CPU outputs (the
plain versions a device="cpu" engine runs) are not fenced. A fault that
surfaces at the fence is raised as ``device.KernelError`` and fails the
solve — the reference swallows its fence's errors, this package never
does. "Compiled" is the port's one compile: ``device.build_kernels()``
building or loading a kernel library (``device.build_count()`` grew
during the dispatch).
"""

from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager
from typing import Iterator, Optional

import torch

from karpenter_tpu_torch import device as devmod
from karpenter_tpu_torch.aot import runtime as aotrt
from karpenter_tpu_torch.observability import kernels as kobs

_ACC: contextvars.ContextVar[Optional[dict]] = contextvars.ContextVar(
    "karpenter_kernel_acc", default=None
)
# per-thread-of-control dispatch nesting stack: each frame is a one-cell
# list accumulating its CHILDREN's elapsed seconds (see dispatch)
_NEST: contextvars.ContextVar[Optional[list]] = contextvars.ContextVar(
    "karpenter_kernel_nest", default=None
)


def _fresh() -> dict:
    return {
        "compile_s": 0.0,
        "execute_s": 0.0,
        "dispatches": 0,
        "compiles": 0,
        # the execute wall split (efficiency observatory): enqueue_s is the
        # host-side call (tracing, arg staging, dispatch), block_s the
        # block_until_ready wait — device work the host genuinely waited on.
        # Both sum into compile_s/execute_s above; they are the same wall,
        # attributed twice at different grain.
        "enqueue_s": 0.0,
        "block_s": 0.0,
    }


@contextmanager
def measure() -> Iterator[dict]:
    """Collect kernel dispatch timings for everything run inside."""
    acc = _fresh()
    token = _ACC.set(acc)
    try:
        yield acc
    finally:
        _ACC.reset(token)


def _cache_size(fn) -> Optional[int]:
    """The port's compile counter: kernel libraries built or loaded in this
    process (device.build_count), whatever `fn` is — a dispatch during
    which it grew paid the build."""
    return devmod.build_count()


def _cuda_devices(out) -> list:
    """The devices of the CUDA tensors among `out` (a tensor, or tuples
    and lists of them, walked), in first-seen order."""
    found: list = []
    todo = [out]
    while todo:
        o = todo.pop()
        if isinstance(o, (tuple, list)):
            todo.extend(reversed(o))
        elif getattr(o, "is_cuda", False) and o.device not in found:
            found.append(o.device)
    return found


def _fence(out) -> None:
    """Wait for the device work behind `out`'s CUDA tensors: one event
    recorded on each of their devices' current stream, then synchronized.
    A fault of that work surfaces here and is raised as KernelError."""
    for dev in _cuda_devices(out):
        with devmod.device_work(f"fence on {dev}"):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            event.synchronize()


def dispatch(fn, *args, kernel: Optional[str] = None, aot_scope: str = ""):
    """Call a jitted function, block until its outputs are ready, and
    attribute the wall time to compile or execute. Transparent (returns the
    outputs) and free when no measurement context is open and no kernel
    name is given.

    Named dispatches first consult the AOT executable table
    (aot/runtime.py): a (kernel, shape) the warm start prepaid executes the
    loaded executable directly — no jit cache, no compile, so a
    warm-started daemon's first solve pays zero compiles. An AOT
    executable that fails at call time (backend drift) is discarded and
    the dispatch falls back to the jit path. `aot_scope` narrows the table
    lookup to executables compiled for a specific device layout (the mesh
    shape of a shard_mapped kernel); it never reaches the observatory, so
    kernel telemetry stays a pure function of the dispatched shapes."""
    acc = _ACC.get()
    if acc is None and kernel is None:
        return fn(*args)
    sig = kobs.shape_signature(args) if kernel is not None else None
    aexe = aotrt.lookup(kernel, sig, aot_scope)
    stack = _NEST.get()
    if stack is None:
        stack = []
        _NEST.set(stack)
    cell = [0.0]  # children's elapsed accumulates here
    stack.append(cell)
    t0 = time.perf_counter()
    t_enqueued = None  # set once the call returns, before any fence
    compiled = False
    served_aot = False
    fenced = False
    try:
        if aexe is not None:
            try:
                out = aexe(*args)
                served_aot = True
            except devmod.KernelError:
                # port: a device fault of an installed executable fails the
                # dispatch — launching again lazily would cover it
                raise
            except Exception as e:  # noqa: BLE001 — degrade to JIT, never fail
                aotrt.discard(
                    kernel, sig,
                    error=f"{type(e).__name__}: {e}", scope=aot_scope,
                )
        if not served_aot:
            before = _cache_size(fn)
            out = fn(*args)
            after = _cache_size(fn)
            compiled = (
                before is not None and after is not None and after > before
            )
        # the dispatch-timeline split (efficiency observatory): everything
        # up to here is ENQUEUE wall (host-side tracing/staging + any
        # compile + the children's nested dispatches); the fence below is
        # BLOCK wall — time the host demonstrably spent waiting on device
        t_enqueued = time.perf_counter()
        # fence when a measurement context wants exact execute wall, or when
        # a compile happened (compile wall must be exact for the registry's
        # recompile accounting; compiles are rare so the fence is free)
        fenced = acc is not None or compiled
        if fenced:
            _fence(out)
    finally:
        elapsed = time.perf_counter() - t0
        stack.pop()
    # innermost-only attribution: subtract the children's wall, credit the
    # parent frame with our FULL elapsed so it subtracts us in turn. The
    # children ran inside the CALL, so they subtract from the enqueue
    # segment only; block wall is always this frame's own.
    self_s = max(0.0, elapsed - cell[0])
    block_s = elapsed - (t_enqueued - t0) if t_enqueued is not None else 0.0
    enqueue_s = max(0.0, self_s - block_s)
    if stack:
        stack[-1][0] += elapsed
    if acc is not None:
        acc["dispatches"] += 1
        acc["enqueue_s"] += enqueue_s
        acc["block_s"] += block_s
        if compiled:
            acc["compiles"] += 1
            acc["compile_s"] += self_s
        else:
            acc["execute_s"] += self_s
    if kernel is not None:
        kobs.registry().record(
            kernel, sig, self_s, compiled, fenced, aot=served_aot,
            enqueue_s=enqueue_s, block_s=block_s,
        )
    return out
