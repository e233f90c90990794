"""aot: the ahead-of-time compile service.

Makes XLA compilation a managed, persistent artifact instead of a lazy
side effect. Three pieces (ROADMAP item 2):

- a **bucket ladder** (aot/ladder.py): a fixed, versioned set of padded
  shape buckets per kernel; runtime dispatches pad to ladder buckets, and
  a dispatch that misses the ladder is a warning event + counter
- an **AOT compiler** (aot/compiler.py): walks the ladder at boot via
  ``jit(...).lower().compile()``, backed by a **persistent executable
  cache** (aot/cache.py) keyed by (catalog content hash, jax/XLA version,
  device kind, bucket, ladder version) with corruption-safe load
- a **warm-start path**: provisioner.prewarm() and the solverd daemon's
  engine factory call ``warm_start``; the runtime executable table
  (aot/runtime.py) serves prepaid executables to every named dispatch

This module stays import-light (no jax); the compiler loads lazily.
"""

from karpenter_tpu_torch.aot import ladder, runtime  # noqa: F401
from karpenter_tpu_torch.aot.cache import ExecutableCache  # noqa: F401
from karpenter_tpu_torch.aot.ladder import LADDER_VERSION, Ladder  # noqa: F401


def warm_start(engine, **kwargs):
    """Load-or-compile the ladder's executables for `engine`; see
    aot/compiler.warm_start."""
    from karpenter_tpu_torch.aot import compiler

    return compiler.warm_start(engine, **kwargs)


def configure_from_options(options) -> None:
    runtime.configure_from_options(options)
