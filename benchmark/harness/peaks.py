"""The card's peaks and the kernels' operation and byte counts, for the
roofline shares.

Frozen copies: the rates from chip_smoke.py:453-463 and PERF.md §6 (the
H100 SXM data sheet and the CUDA C++ Programming Guide's throughput table
for compute capability 9.0); `scan_ops` from
karpenter_tpu_torch/aot/compiler.py:191-194 as PERF.md §6's B14 row uses it
(chip_smoke.py:6762-6766); the bytes as chip_smoke.py:6792 counts them:
every operand read once and every output written once, here at the real
sizes (`probes.resolve`).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# results an SM gives a clock for 64-bit floating-point add, multiply and
# compare, and for 32-bit integer add and logic, at compute capability 9.0:
# 64 x 132 SMs x 1.98 GHz, one instruction an operation
OPS_PER_S = 64 * 132 * 1.98e9


def scan_ops(steps: int, G: int, U: int, D: int, N: int) -> int:
    """float64 compares and subtractions of the fused scan (kt_solve_scan):
    per step the claims' fit rows (G x U x D), the taken claim's headroom
    update (2 x U x D) and the existing nodes' fit test (N x D)."""
    return int(steps) * (int(G) * int(U) * int(D) + 2 * int(U) * int(D) + int(N) * int(D))


def scan_bound_s(steps: int, G: int, U: int, D: int, N: int, nbytes: int) -> float:
    """The least time the card could take for one scan: the larger of its
    operations at OPS_PER_S and its bytes at the memory rate."""
    return max(nbytes / HBM_BYTES_PER_S, scan_ops(steps, G, U, D, N) / OPS_PER_S)
