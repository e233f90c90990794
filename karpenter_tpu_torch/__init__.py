"""karpenter-tpu on PyTorch and CUDA: the provisioning solve ported to an
NVIDIA H100.

The JAX package `karpenter_tpu` is the reference; this package runs the same
provisioning solve (`scheduler.Scheduler.solve`) with its batched
feasibility sweep in hand-written CUDA kernels (csrc/feasibility.cu), built
at first use with nvcc. It imports torch and numpy, never jax, and nothing
of the reference package: the host modules it needs are copies under the
same relative paths.

Layer map:
  apis/ scheduling/ utils/   data model and requirement algebra (copies)
  scheduler/                 Scheduler.solve and its host loop (copies)
  ops/ffd.py                 the device FFD driver (copy, plain driver only)
  ops/catalog.py             CatalogEngine: catalog state on the card
  ops/feasibility.py         kernel wrappers + plain torch versions
  csrc/feasibility.cu        the CUDA kernels
  device.py                  device resolution and the kernel build
"""

__version__ = "0.1.0"

GROUP = "karpenter.sh"
