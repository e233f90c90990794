"""aot: the ahead-of-time compile service.

Makes the kernels' build and first launch a managed, persistent artifact
instead of a lazy side effect of the first solve. Three pieces:

- a **bucket ladder** (aot/ladder.py): a fixed, versioned set of padded
  shape buckets per kernel; runtime dispatches pad to ladder buckets, and
  a dispatch that misses the ladder is a warning event + counter
- an **AOT compiler** (aot/compiler.py): walks the ladder at boot — the
  nvcc build of the kernel libraries (or their load from the cache's
  library directory) and one checked launch per bucket — backed by a
  **persistent executable cache** (aot/cache.py) of small per-bucket
  records keyed by (catalog content hash, torch/CUDA/nvcc versions, device,
  bucket, ladder version) with corruption-safe load
- a **warm-start path**: provisioner.prewarm() and the solverd daemon's
  engine factory call ``warm_start``; the runtime executable table
  (aot/runtime.py) serves the warm-started buckets to every named dispatch

This module stays import-light; the compiler loads lazily.
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
