#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-3 only (build + kernel checks)
    python3 chip_smoke.py --mesh     # phases 1-2, 4, 5c and 5b (two or more cards)
    python3 chip_smoke.py --turns TREE [TREE ...]   # the group and sweep
                                     # wrappers of each checkout, timed in turns

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from karpenter_tpu_torch/csrc (nvcc, sm_90a, one
     nvcc per source, all started together) and print ptxas's registers and
     spills per kernel;
  3. hold each kernel against its plain torch version on the card, bit for
     bit: the feasibility kernels at the solve's shapes, on ragged edges and
     on bounded/complement rows (kt_row_compat through req_rows_vs_sets
     and through req_rows_vs_targets against both targets and one, R, K
     and the set counts past 32 and not multiples of it; kt_cube through
     production_cube and through cube_rows over rows read by index: P past
     a tile, R and K past 32, I not a multiple of a block, a type with no
     offering, an offering never available, one used row, no used row with
     the membership padded, types of ~300 offerings); uid_project on
     ragged type counts and U=1, and in its factored form (the fused
     solve's famu_ok from tmpl_mask and fam_mask read as they are) at T 1,
     2 and 4, F 1, 7 and 64, U 1, 33 and 70, I 1, 31 and 1008 (all-false
     rows among them) and at the workload's shape, the masks also as row
     ranges of one buffer and one byte past 16-byte alignment;
     fits_matrix (int32 and float32) and stage_plane on random inputs
     (phase 7 checks them again on the workload's inputs; those launches
     are the only ones they have: no path of the reference runs them);
     offering_reduce (kt_cube with no compat plane) on ragged P/R/O/K
     (K=0, an offering never available);
     kt_group_solve in its four modes (solve_block, solve_block_core,
     solve_block_scatter with edge-padded duplicate, negative and dropped
     slots, and delta_pass: that scatter, then the pass's finalize in the
     launch's last block, on a counter left stale) on random operands
     (all-infeasible groups, zero-request dims,
     price ties, K=0, R and K past 2048, I past a chunk of 1024 types, a
     chunk's offerings past a window of 32,768), one launch a call; the sharded wrappers'
     kt_cube_fused and kt_group_solve on ragged operands (R and K past 32,
     I past a block, shards of padding only, a type without offerings and
     one never available) on meshes repeating the card 1-3 times, the
     entity rows staged from the host or read in place on the card, one
     launch per call; delta_scatter with edge-padded duplicate slots and
     delta_finalize; the fused scan on the 27 operands of four small solves
     this script sets up (no nodes/limits; existing nodes with seeded
     usage; a second NodePool with a cpu limit; both at once with two
     templates), in both of the kernel's designs (resident, which the
     wrapper takes for these shapes, and global, forced): the classic
     outputs, the full state (solve_scan_full), and solve_scan_resume from
     the full state of a prefix against the plain resume and against
     solve_scan_full on the whole list; the plain solve again with a claim
     axis past the resident design's shared-memory budget, which the public
     entry point must launch in the global design;
  4. the main path: the bench workload (kwok catalog x7 = 1008 types and
     8064 offerings, 50,000 pods from 200 shapes drawn with RandomState(7),
     one `default` NodePool, empty cluster) through the port's
     Scheduler.solve with a CUDA CatalogEngine and the fused scan left at
     `auto`, cold once and warm twice; launch counts are zeroed just before
     and read just after, and every scan launch must have taken the
     resident design (here, in phase 5 and in phase 5b). Exactly one
     kt_row_compat launch a row batch (types and offerings together) and
     one kt_cube launch a sweep, in each solve, and no kt_membership; the
     sweeps' shapes are logged. One kt_uid_project launch a scan solve
     (famu_ok); in one more warm solve the famu_ok build, recorded op by
     op, is the masks' one upload and that one launch, and a profiled warm
     solve holds no elementwise & kernel. Then the slice-1 path (scan off, the
     native walk) on the same workload, cold and warm, with the same
     decisions and the same launch rule;
  5. delta solves (KARPENTER_TPU_DELTA=on, the fused scan on, a self-check
     every 5 warm passes) on the same workload: one cold pass, then 12
     churn passes that each add 24 pods extending the FFD stream as an
     exact suffix; one scan residency miss, 12 warm resumes of 24 steps
     each, identical self-checks, the last pass's decisions equal to a
     delta-off solve, constant residency bytes, and flat
     torch.cuda.memory_allocated() over 3 identical warm re-solves. Then
     the group solver on the workload's encode_pods_for_packer groups:
     solve_block and solve_block_core there against their plain versions,
     then the path (counts zeroed just before, the checks' own launches
     left out): the full solve, and with delta on a cold pass, a
     count-only pass (0 groups solved) and a pass with new shapes, each
     with its wall ms; exact launches: one solve_block a full solve and
     self-check, one delta_pass a pass with a frontier (one kt_group_solve
     launch: the frontier and the pass's finalize) and no delta_finalize
     there, one delta_finalize a count-only pass, and no membership,
     offering_reduce, solve_block_core, solve_block_scatter or
     delta_scatter; the C entries counted per pass agree;
  5c. the topology-aware driver (ops/ffd_topo.py; run before 5b, which
     reads its decisions): bench.py's topology leg at its own size (20,000
     pods in 4 deployments app-0..3, 1 cpu / 1Gi, each zone-spread with
     maxSkew 1, DoNotSchedule, over its own app label; the kwok catalog
     x7; one NodePool; empty cluster) on a CUDA engine, one cold and 5 warm
     solves: each one device solve served by _TopoSolve (its counter),
     one `topo` decline of the fused scan, no fallback, no pod error, no
     kt_solve_scan, kt_group_solve, kt_uid_project or kt_membership launch,
     one kt_row_compat a row batch and one kt_cube a sweep (at least one in
     the cold solve), counted by C entry point with the shapes logged; wall
     ms of each solve and the warm p50; decisions equal across the solves
     and to a device="cpu" engine's; the row batch and the sweep the path
     gave the kernels held against their plain versions. Then a 2,000-pod
     mixed case on the kwok catalog against the host loop (engine=None):
     a topology leg (zone and hostname spread, required anti-affinity on
     hostname, preferred node affinity, a second NodePool tainted
     PreferNoSchedule) and a relax leg (preferred and multi-term node
     affinity, no topology: the plain driver declines, the topology driver
     serves), each saying which attempt served it; one JSON line
     {"topology": {...}};
  4c. the kernel observatory (phase_observatory; run after 5c, whose
     20,000-pod topology leg it reuses with phase 4's workload and phase
     5's churn): the registry reset, one cold and one warm solve of each
     kind (scan, walk, delta churn, delta group pass, topology), then the
     registry sealed and, each inside ktime.measure() and
     registry().batch_scope(label), one warm scan solve, one walk solve, two
     churn passes, one group pass with new shapes and one warm topology
     solve: each batch's named dispatches equal the wrapper launches
     LAUNCHES counted in the same window under DISPATCH_OF (a warm scan
     solve is exactly feasibility.cube 1 and packer.solve_scan 1, a churn
     pass one packer.solve_scan_resume, the group pass one
     packer.delta_pass); no compile in the phase and no steady recompile;
     every dispatch fenced with block_s > 0; each batch's device_busy_s
     and host_stall_fraction printed (the topology solve's beside phase
     5c's profiled busy share); sample_device_memory() equal to
     torch.cuda.memory_allocated() and memory_stats(); a ladder derived
     from the observed counts (the scan's 27-operand signature parsed); a
     profiler capture (efficiency.profiler().arm, its worker thread) around
     one warm solve whose trace.json parses, its kernel events counted; in
     a child process, a fence after a kt_delta_finalize launch given a
     bogus pointer raises KernelError. One JSON line {"observatory": {...}};
  5b. the solver mesh (phase_mesh) on the same workload, on a 1-device
     mesh, on a 2-shard mesh (two cards when the machine has them, else
     cuda:0 twice) and, with four cards or more, on a 4-shard mesh of four
     cards: a scan solve cold and warm (decisions equal to phase
     4's), on the 2-shard mesh phase 5c's topology solve cold and warm
     (decisions equal to phase 5c's, one kt_cube_fused per card a sweep),
     a delta churn of 6 passes with one self-check (1 miss, then
     warm, decisions equal to delta off, one resident state per shard),
     the group solver's sharded solve of the 200 groups (equal to the
     unsharded solve_block); every replica's scan outputs equal to each
     other, and exact launch counts per card: one kt_cube_fused a sweep,
     one kt_group_solve a block solve, one kt_solve_scan per replica, and
     no unsharded cube or block kernel;
  6. decision identity on a 5,000-pod prefix: CUDA with the scan, CUDA with
     the walk and a device="cpu" engine (walk, plain versions); and the
     nodes-and-limits solve with the scan on CUDA against the plain scan on
     the CPU;
  7. one JSON line {"kernels": [...]}: per kernel its launches on its path
     (phase 4, phase 5 for the delta and group kernels, phase 5b for the
     sharded twins, phase 3 and the workload checks for fits_matrix and
     stage_plane: fits of the 50k pods' quantized requests against the
     1008 allocatables, the stage plane of a sweep of the 200 shapes),
     agreement with
     the plain version, and CUDA-event medians of the kernel, the plain
     version and a PyTorch yardstick on the inputs its path gave it,
     beside its bound (the larger of bytes over the memory rate and
     operations over the rate for their type); the scan's entry also holds
     both designs on phase 4's operands (each against the plain loop), their
     device times taken in turns (resident, global, global, resident), the
     resident design at 256, 512 and 1024 threads, and ptxas's registers,
     shared memory and spills for both kernels; the sharded cube's and
     group solve's entries also hold the host time of a call split by part
     (wrapper_breakdown), the per-shard composition they replace rebuilt from public
     pieces with its own breakdown and device time, and both timed in
     turns (old, new, new, old); solve_block's, solve_block_core's and
     solve_block_scatter's hold the host time by part and kt_group_solve's
     phase split (block 0's phase timestamps: pack, offering pass, type
     pass, reduction) and ptxas's report; delta_scatter's holds its host
     time by part and it and index_put_ timed in turns; delta_pass's the
     delta group pass (cold, count-only, new shapes, self-check off)
     through GroupResidency.solve: its wall ms, device operations and host
     time by part (fingerprints, pack groups, upload, enqueue, copy back).
     The kernels of no path (OFF_PATH: fits_matrix, stage_plane,
     offering_reduce, solve_block_core, solve_block_scatter, delta_scatter,
     membership) have 0 launches, held so, and phase 3's and phase 7's
     check launches under `check_launches`; row_compat's and cube's entries
     (on the row batch and the sweep the main path gave them) also hold the
     host time by part and ptxas's report. Beside the kernels line, the
     launch floor: an empty kernel's device time and a no-op's host time
     through device.launch; and the dispatch floor: the same kernel through
     a named ktime.dispatch, without and with a measure() context (which
     fences every call), host us a call and device ms;
  8. last line {"ok": true, "device": {...}}.

--turns times the group solver's and the catalog sweep's wrappers of one or
more checkouts of this repository, one after the other in the order given
(parent, this, this, parent for a before/after), each in a process of its
own that imports that checkout's karpenter_tpu_torch and this script's
helpers, on the bench workload: B9 solve_block on the 200 groups, B10
solve_block_core on the first 128, B11 delta_scatter_rows of those rows
into a 256-row core matrix (and index_put_ beside it in turns), B13
sharded_solve_block on a 2-shard mesh of the first card twice; B1 on a
fresh 7-row batch against the types and the offerings, B3 at phase 4's
sweep shape (the engine's kernels: cube_rows, or where the checkout lacks
it the two gathers and production_cube; and production_cube alone), the
whole CatalogEngine.feasibility sweep, and CatalogEngine._ensure_rows on
a fresh 7-row batch; B6, the famu_ok build at the workload's shape (the
masks from the host to famu_ok on the card: the checkout's own
composition) and its device work alone; B12, a delta pass's kernels on the
workload's first 128 groups (delta_pass, or where the checkout lacks it
solve_block_scatter then delta_finalize) and the delta group pass through
GroupResidency.solve cold, count-only and with new shapes. Each checked
against its plain version, then its
wrapper ms, device ms by kernel, device operations, host us by part and C
launches per call; all in chiprun_out/turns.json.

Imports torch, numpy and karpenter_tpu_torch only.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# 32-bit integer and logic operations per second, the kernels' word ops:
# 64 results per clock per SM for 32-bit integer add and bitwise AND/OR/XOR
# on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput table), times 132 SMs at the 1.98 GHz boost clock
# (H100 SXM data sheet)
WORD_OPS_PER_S = 64 * 132 * 1.98e9
# float64 operations per second outside the tensor cores (H100 SXM data
# sheet: 34 TFLOP/s FP64), the rate of the fused scan's compares and
# subtractions
F64_OPS_PER_S = 34e12
NUM_PODS = 50_000
CATALOG_REPEAT = 7
PREFIX_PODS = 5_000
SMALL_PODS = 2_000
CHURN_PASSES = 12
CHURN_PODS = 24
SELF_CHECK_EVERY = 5
MESH_CHURN_PASSES = 5  # the mesh phase's churn passes; the last one self-checks
SOURCE = {
    "row_compat": "karpenter_tpu_torch/csrc/feasibility.cu",
    "membership": "karpenter_tpu_torch/csrc/feasibility.cu",
    "cube": "karpenter_tpu_torch/csrc/feasibility.cu",
    "uid_project": "karpenter_tpu_torch/csrc/feasibility.cu",
    "solve_scan": "karpenter_tpu_torch/csrc/scan.cu",
    "offering_reduce": "karpenter_tpu_torch/csrc/feasibility.cu",
    "solve_block": "karpenter_tpu_torch/csrc/packer.cu",
    "solve_block_core": "karpenter_tpu_torch/csrc/packer.cu",
    "solve_block_scatter": "karpenter_tpu_torch/csrc/packer.cu",
    "delta_scatter": "karpenter_tpu_torch/csrc/packer.cu",
    "delta_finalize": "karpenter_tpu_torch/csrc/packer.cu",
    "delta_pass": "karpenter_tpu_torch/csrc/packer.cu",
    "solve_scan_full": "karpenter_tpu_torch/csrc/scan.cu",
    "solve_scan_resume": "karpenter_tpu_torch/csrc/scan.cu",
    "fits_matrix": "karpenter_tpu_torch/csrc/feasibility.cu",
    "stage_plane": "karpenter_tpu_torch/csrc/feasibility.cu",
    "sharded_cube": "karpenter_tpu_torch/csrc/feasibility.cu",
    "sharded_solve_block": "karpenter_tpu_torch/csrc/packer.cu",
    "sharded_solve_scan": "karpenter_tpu_torch/csrc/scan.cu",
    "sharded_solve_scan_full": "karpenter_tpu_torch/csrc/scan.cu",
    "sharded_solve_scan_resume": "karpenter_tpu_torch/csrc/scan.cu",
}
REPLACES = {
    "row_compat": "karpenter_tpu/ops/feasibility.py:48",
    "membership": "karpenter_tpu/ops/feasibility.py:177",
    "cube": "karpenter_tpu/ops/feasibility.py:265",
    "uid_project": "karpenter_tpu/ops/feasibility.py:332",
    "solve_scan": "karpenter_tpu/ops/packer.py:494",
    "offering_reduce": "karpenter_tpu/ops/feasibility.py:430",
    "solve_block": "karpenter_tpu/ops/packer.py:133",
    "solve_block_core": "karpenter_tpu/ops/packer.py:162",
    "solve_block_scatter": "karpenter_tpu/ops/packer.py:162 + :185",
    "delta_scatter": "karpenter_tpu/ops/packer.py:185",
    "delta_finalize": "karpenter_tpu/ops/packer.py:196",
    "delta_pass": "karpenter_tpu/ops/packer.py:162 + :185 + :196",
    "solve_scan_full": "karpenter_tpu/ops/packer.py:833",
    "solve_scan_resume": "karpenter_tpu/ops/packer.py:840",
    "fits_matrix": "karpenter_tpu/ops/feasibility.py:222",
    "stage_plane": "karpenter_tpu/ops/feasibility.py:384",
    "sharded_cube": "karpenter_tpu/ops/feasibility.py:305",
    "sharded_solve_block": "karpenter_tpu/ops/packer.py:217",
    "sharded_solve_scan": "karpenter_tpu/ops/packer.py:930",
    "sharded_solve_scan_full": "karpenter_tpu/ops/packer.py:954",
    "sharded_solve_scan_resume": "karpenter_tpu/ops/packer.py:975",
}
# the C entry points each row launches
ENTRY_POINTS = {
    "row_compat": "kt_row_compat (types and offerings in one launch; req_rows_vs_targets)",
    "membership": "kt_membership",
    "cube": "kt_cube (both planes, the rows read by index; cube_rows)",
    "uid_project": "kt_uid_project (factored: tmpl_mask and fam_mask read as they are; "
                   "uid_project_factored)",
    "solve_scan": "kt_solve_scan",
    "offering_reduce": "kt_cube (the offering plane alone)",
    "solve_block": "kt_group_solve (finalize mode)",
    "solve_block_core": "kt_group_solve (core mode)",
    "solve_block_scatter": "kt_group_solve (scatter mode)",
    "delta_scatter": "kt_delta_scatter",
    "delta_finalize": "kt_delta_finalize",
    "delta_pass": "kt_group_solve (pass mode: the scatter, then the finalize in the last block)",
    "solve_scan_full": "kt_solve_scan",
    "solve_scan_resume": "kt_solve_scan",
    "fits_matrix": "kt_fits_matrix_i32 / kt_fits_matrix_f32",
    "stage_plane": "kt_stage_plane",
    "sharded_cube": "kt_cube_fused",
    "sharded_solve_block": "kt_group_solve (finalize mode, one launch a card)",
    "sharded_solve_scan": "kt_solve_scan",
    "sharded_solve_scan_full": "kt_solve_scan",
    "sharded_solve_scan_resume": "kt_solve_scan",
}
# the kernels no path launches: the reference runs B4 and B7 on none; since
# the group solve became one kt_group_solve launch a call the standalone
# offering_reduce (B8), solve_block_core (B10) and delta_scatter (B11)
# wrappers run on none either, since the sweep became one kt_cube launch
# neither does membership (B2: a catalog without offerings would), and
# since a delta pass with a frontier became one delta_pass launch neither
# does solve_block_scatter.
# Their entries give the paths' count, 0, as `launches` and phase 3's and
# phase 7's check launches as `check_launches`; the kernels line holds them
# to exactly that.
OFF_PATH = ("fits_matrix", "stage_plane", "offering_reduce", "solve_block_core", "delta_scatter",
            "membership", "solve_block_scatter")
# float32 operations per second outside the tensor cores (H100 SXM data
# sheet: 67 TFLOP/s FP32), the rate of fits_matrix's float32 compares
F32_OPS_PER_S = 67e12
# the fused scan's two kernels (csrc/scan.cu), as the profiler names them
SCAN_KERNELS = ["solve_scan_resident_kernel", "solve_scan_kernel"]
SCAN_BLOCK_SIZES = (256, 512, 1024)
PTXAS: dict = {}  # scan kernel -> ptxas's report, filled by phase_build
GROUP_PTXAS: dict = {}  # the same for kt_group_solve's kernel
FEAS_PTXAS: dict = {}  # the same for kt_row_compat's and kt_cube's kernels
FEAS_KERNELS = ["row_compat_kernel", "cube_kernel", "uid_project_kernel"]


def log(msg: str) -> None:
    print(msg, flush=True)


# -- inputs --------------------------------------------------------------------


def random_row_inputs(rng, R, N, K, W, dev, bounded=0.2, complement=0.3):
    """Random requirement rows and sets at the row kernel's layout: slots
    past the vocabulary carry slot_key -1 and value_int NOT_INT, some rows
    and sets carry Gt/Lt bounds, some are complements."""
    from karpenter_tpu_torch.ops.encoding import NO_GT, NO_LT, NOT_INT

    G = 32 * W
    used = max(1, int(G * 0.8))
    slot_key = np.full(G, -1, np.int32)
    slot_key[:used] = rng.randint(0, K, size=used)
    value_int = np.full(G, NOT_INT, np.int32)
    ints = rng.rand(used) < 0.5
    value_int[:used][ints] = rng.randint(-50, 50, size=int(ints.sum()))

    def bounds(shape):
        gt = np.full(shape, NO_GT, np.int32)
        lt = np.full(shape, NO_LT, np.int32)
        m = rng.rand(*shape) < bounded
        gt[m] = rng.randint(-60, 40, size=int(m.sum()))
        m = rng.rand(*shape) < bounded
        lt[m] = rng.randint(-40, 60, size=int(m.sum()))
        return gt, lt

    def words(shape):
        return rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32) & (
            rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
        )

    r_gt, r_lt = bounds((R,))
    s_gt, s_lt = bounds((N, K))
    host = (
        rng.randint(0, K, size=R).astype(np.int32),
        rng.rand(R) < complement,
        rng.rand(R) < 0.7,
        r_gt,
        r_lt,
        words((R, W)),
        rng.rand(N, K) < 0.6,
        rng.rand(N, K) < complement,
        rng.rand(N, K) < 0.7,
        s_gt,
        s_lt,
        words((N, W)),
        slot_key,
        value_int,
    )
    return tuple(_to(a, dev) for a in host)


def random_cube_inputs(rng, P, R, I, O, K, dev):
    """Random sweep inputs: sparse membership, mostly-compatible compat
    matrices, owner-major offerings (each type owns a contiguous range)."""
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    host = (
        rng.rand(P, R) < min(1.0, 4.0 / R),
        rng.rand(R, I) < 0.9,
        rng.rand(R, O) < 0.9,
        rng.rand(O, K) < 0.05,
        rng.rand(P, K) < 0.5,
        rng.rand(O) < 0.9,
        owner,
    )
    return tuple(_to(a, dev) for a in host)


def random_offering_inputs(rng, P, R, O, K, I, dev):
    """offering_reduce inputs: owner-major offerings, offering 0 never
    available. Returns the six operands (owner indices)."""
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    available = rng.rand(O) < 0.9
    available[0] = False
    host = (
        rng.rand(P, R) < min(1.0, 4.0 / R),
        rng.rand(R, O) < 0.9,
        rng.rand(O, K) < 0.05,
        rng.rand(P, K) < 0.5,
        available,
        owner,
    )
    return tuple(_to(a, dev) for a in host)


def random_target_inputs(rng, R, sizes, K, W, dev, bounded=0.2, complement=0.3):
    """A row batch (its six arrays) and one set tuple per size in `sizes`
    (the types, then the offerings), slot_key and value_int, at the row
    kernel's layout (random_row_inputs). req_rows_vs_targets takes the
    batch as feasibility.row_table of the six arrays."""
    first = random_row_inputs(rng, R, sizes[0], K, W, dev, bounded, complement)
    targets = [first[6:12]] + [random_row_inputs(rng, 1, n, K, W, dev, bounded, complement)[6:12]
                               for n in sizes[1:]]
    return first[:6], targets, first[12], first[13]


def random_sweep_inputs(rng, P, R, Rtot, I, O, K, dev):
    """cube_rows' inputs: membership [P, pow2(R)] (columns past R padding,
    all False), key_present, R sorted row ids out of Rtot resident rows,
    the resident matrices, and owner-major offerings with a type that has
    none (when I > 2) and offering 0 never available."""
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    if I > 2:
        owner[owner == I // 2] = I // 2 + 1
    available = rng.rand(O) < 0.9
    available[0] = False
    membership = np.zeros((P, 1 << max(0, (max(R, 1) - 1).bit_length())), dtype=bool)
    membership[:, :R] = rng.rand(P, R) < min(1.0, 4.0 / max(R, 1))
    rows = np.sort(rng.choice(Rtot, size=R, replace=False)).astype(np.int32)
    host = (membership, rng.rand(P, K) < 0.5, rows, rng.rand(Rtot, I) < 0.9, rng.rand(Rtot, O) < 0.9,
            rng.rand(O, K) < 0.05, available, owner)
    return tuple(_to(a, dev) for a in host)


# cube_rows' phase-3 shapes (P, R, Rtot, I, O, K): the workload's sweep; a
# diverse backlog's; P past a tile with R and K past 32 and I not a
# multiple of a block; one used row; all-trivial rows (R = 0, membership
# padded); types of ~300 offerings each with K = 0; one of everything
SWEEP_CHECK_SHAPES = ((16, 8, 40, 1008, 8064, 8), (256, 128, 300, 1008, 8064, 8),
                      (45, 37, 50, 1000, 3001, 40), (33, 1, 5, 37, 75, 8), (40, 0, 3, 20, 400, 8),
                      (7, 5, 9, 3, 900, 0), (1, 1, 1, 1, 1, 8))
# req_rows_vs_targets' phase-3 shapes (R, target sizes, K, W): the
# workload's batch against both targets and the types alone; R, K and N
# past 32 and not multiples of it; one row against one set of each
TARGET_CHECK_SHAPES = ((7, (1008, 8064), 8, 8), (7, (1008,), 8, 8), (128, (1008, 8064), 8, 8),
                       (37, (45, 300), 40, 2), (70, (1000, 3001), 16, 4), (1, (1, 1), 33, 9),
                       (33, (257,), 8, 2))


def random_group_inputs(rng, G, R, K, I, O, D, dev):
    """solve_block operands: prices from a small set (ties), zero-request
    dims, group 0 fitting no type (all-infeasible), negative allocatable
    on a few types, types with no available offering (price inf)."""
    owner = np.sort(rng.randint(0, I, size=O)).astype(np.int32)
    available = rng.rand(O) < 0.9
    offer_price = rng.choice([0.25, 0.5, 1.0, 2.0], size=O).astype(np.float32)
    price = np.full(I, np.inf, dtype=np.float32)
    np.minimum.at(price, owner[available], offer_price[available])
    requests = rng.randint(0, 16, size=(G, D)).astype(np.int32)
    requests[rng.rand(G, D) < 0.3] = 0
    requests[0] = 1 << 20
    alloc = rng.randint(-2, 64, size=(I, D)).astype(np.int32)
    host = (
        np.concatenate([rng.rand(G, R) < min(1.0, 4.0 / R), rng.rand(G, K) < 0.5], axis=1),
        np.concatenate([requests, rng.randint(0, 500, size=(G, 1)).astype(np.int32)], axis=1),
        rng.rand(R, I) < 0.9,
        rng.rand(R, O) < 0.9,
        rng.rand(O, K) < 0.05,
        available,
        owner,
        alloc,
        price,
    )
    return tuple(_to(a, dev) for a in host)


# kt_group_solve's phase-3 shapes (G, R, K, I, O, D): the group solver's
# (256 groups x 1008 types), single rows, K=0, R past 32 and not a multiple
# of it, R and K past 2048 (past the 64 words the kernel once held), I past a block of
# 1024 threads (one chunk of types), I past nine chunks, and one chunk's
# offerings past a window of 32,768 usable bits (two windows)
GROUP_CHECK_SHAPES = ((256, 64, 8, 1008, 8064, 4), (1, 1, 0, 1, 1, 4), (37, 5, 8, 40, 77, 4),
                      (200, 16, 0, 1008, 2000, 6), (9, 33, 40, 300, 900, 2),
                      (5, 2100, 2050, 300, 900, 4), (64, 7, 8, 1025, 8064, 4),
                      (3, 3, 2, 9000, 30000, 4), (5, 3, 2, 100, 40000, 4))


def scatter_inputs(rng, args, cap):
    """The frontier as the residency hands it to solve_block_scatter: a
    random [cap, 3] core matrix; the groups' last quarter edge-padded (rows
    equal to the last real group's, slots repeating its slot); distinct
    slots for the real groups, one given as slot - cap (negative, counting
    from the end) and one past the end either way (dropped)."""
    gb, gi = args[0].clone(), args[1].clone()
    G = gb.shape[0]
    real = max(1, G - G // 4)
    gb[real:] = gb[real - 1]
    gi[real:] = gi[real - 1]
    slots = rng.permutation(cap)[:real].astype(np.int32)
    if real >= 3:
        slots[0] -= cap
        slots[1] = cap + 3 if rng.rand() < 0.5 else -cap - 2
    slots = np.pad(slots, (0, G - real), mode="edge")
    core = np.stack([rng.randint(0, 1008, size=cap), rng.randint(0, 2, size=cap),
                     rng.randint(0, 200, size=cap)], axis=1).astype(np.int32)
    return _to(core, gb.device), _to(slots, gb.device), (gb, gi) + tuple(args[2:])


def group_mode_checks(rng, G, R, K, I, O, D, dev) -> int:
    """kt_group_solve in its four modes through solve_block, solve_block_core,
    solve_block_scatter and delta_pass (a pass's order over the frontier's
    slots and older rows, its counter left stale) on random operands, each
    bit for bit against its plain version and one launch a call; returns
    the cases checked."""
    from karpenter_tpu_torch.ops import packer

    args = random_group_inputs(rng, G, R, K, I, O, D, dev)
    label = f"G={G} R={R} K={K} I={I} O={O} D={D}"
    cap = max(8, 2 * G)
    core, slots, sargs = scatter_inputs(rng, args, cap)
    g = G + int(rng.randint(0, 8))
    gb = max(8, 1 << (g - 1).bit_length())
    order = _to(np.pad(rng.randint(0, cap, size=g).astype(np.int32), (0, gb - g), mode="edge"), dev)
    counts = _to(np.pad(rng.randint(0, 900, size=g).astype(np.int32), (0, gb - g)), dev)
    counter = torch.full((1,), 7, dtype=torch.int32, device=dev)  # stale: the launch zeroes it
    for name, run, plain in (
        ("solve_block", lambda: packer.solve_block(*args), lambda: packer.solve_block_plain(*args)),
        ("solve_block_core", lambda: packer.solve_block_core(*args),
         lambda: packer.solve_block_core_plain(*args)),
        ("solve_block_scatter", lambda: packer.solve_block_scatter(core.clone(), slots, *sargs),
         lambda: packer.delta_scatter_rows_plain(core.clone(), slots, packer.solve_block_core_plain(*sargs))),
        ("delta_pass",
         lambda: (lambda c: (packer.delta_pass(c, slots, *sargs[:2], order, counts, *sargs[2:],
                                               counter=counter), c))(core.clone()),
         lambda: (lambda c: (packer.delta_pass_plain(c, slots, *sargs[:2], order, counts, *sargs[2:]),
                             c))(core.clone())),
    ):
        l0 = dict(_count_launches())
        got = run()
        moved = {k: v - l0[k] for k, v in _count_launches().items() if v != l0[k]}
        assert moved == {name: 1}, f"{name} {label}: launches {moved}"
        check_equal(f"{name} {label}", got, plain())
    return 4


def random_mesh_inputs(rng, P, n, R, K, I, O, D):
    """Host operands of the sharded cube and group solve on an n-shard
    mesh: P entities padded as the engine pads them (pow2, aligned to
    mesh_multiple(n); padding rows all-False / zero, so a shard may hold
    only padding); owner-major offerings with type 3 owning none and type
    5's never available; prices from a small set (ties), group 0 fitting
    no type. Returns (P2, membership, key_present, group_ints, req_compat,
    offer_compat, custom_need, available, owner, alloc_q, price)."""
    from karpenter_tpu_torch.mesh import mesh_multiple

    align = mesh_multiple(n)
    P2 = -(-max(1 << max(0, (P - 1).bit_length()), align) // align) * align
    owner = np.sort(rng.choice(np.setdiff1d(np.arange(I), [3]), size=O)).astype(np.int32)
    available = rng.rand(O) < 0.9
    available[owner == 5] = False
    offer_price = rng.choice([0.25, 0.5, 1.0, 2.0], size=O).astype(np.float32)
    price = np.full(I, np.inf, dtype=np.float32)
    np.minimum.at(price, owner[available], offer_price[available])
    membership = np.zeros((P2, R), dtype=bool)
    membership[:P] = rng.rand(P, R) < min(1.0, 4.0 / R)
    key_present = np.zeros((P2, K), dtype=bool)
    key_present[:P] = rng.rand(P, K) < 0.5
    group_ints = np.zeros((P2, D + 1), dtype=np.int32)
    group_ints[:P, :D] = rng.randint(0, 16, size=(P, D)) * (rng.rand(P, D) > 0.3)
    group_ints[0, :D] = 1 << 20
    group_ints[:P, D] = rng.randint(1, 500, size=P)
    return (P2, membership, key_present, group_ints, rng.rand(R, I) < 0.9, rng.rand(R, O) < 0.9,
            rng.rand(O, K) < 0.05, available, owner,
            rng.randint(-2, 64, size=(I, D)).astype(np.int32), price)


def sharded_kernel_checks(dev=torch.device("cuda")):
    """kt_cube_fused (B5) and kt_group_solve (B13) through their wrappers
    against the plain versions, bit for bit, on ragged operands (R and K
    past 32 and not multiples of it, I not a multiple of a block and past
    1024, P and G not multiples of 32, a shard of padding only, a type
    without offerings, one whose offerings are never available, price
    ties), on meshes repeating the card 1, 2 and 3 times, with the entity
    operands on the host (staged) and on the card (read in place): one
    launch per call on the one card."""
    from karpenter_tpu_torch.mesh import Mesh
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    rng = np.random.RandomState(3)
    n_checks = 0
    for P, R, K, I, O, D in ((45, 37, 45, 1000, 6000, 4), (3, 8, 8, 1008, 8064, 4),
                             (200, 16, 0, 1500, 3001, 2), (70, 70, 9, 130, 900, 6)):
        for n in (1, 2, 3):
            mesh = Mesh([dev] * n)
            P2, mem, kp, gi, rc, oc, cn, av, ow, aq, pr = random_mesh_inputs(rng, P, n, R, K, I, O, D)
            cat_d = [_to(a, dev) for a in (rc, oc, cn, av, ow)]
            plain = feas.production_cube_plain(_to(mem, dev), cat_d[0], cat_d[1], cat_d[2], _to(kp, dev),
                                               cat_d[3], cat_d[4])
            gb = np.concatenate([mem, kp], axis=1)
            grp_d = cat_d + [_to(aq, dev), _to(pr, dev)]
            plain_g = packer.solve_block_plain(_to(gb, dev), _to(gi, dev), *grp_d)
            for where in ("host", "card"):
                ent = (lambda a: torch.from_numpy(a)) if where == "host" else (lambda a: _to(a, dev))
                l0 = dict(_count_launches())
                got = feas.sharded_cube(mesh)(ent(mem), cat_d[0], cat_d[1], cat_d[2], ent(kp), cat_d[3],
                                              cat_d[4])
                check_equal(f"kt_cube_fused P={P2} R={R} K={K} I={I} O={O} on {n} shards ({where})",
                            got, plain)
                got_g = packer.sharded_solve_block(mesh)(ent(gb), ent(gi), *grp_d)
                check_equal(f"kt_group_solve G={P2} R={R} K={K} I={I} O={O} D={D} on {n} shards ({where})",
                            got_g, plain_g)
                moved = {k: v - l0[k] for k, v in _count_launches().items() if v != l0[k]}
                assert moved == {"sharded_cube": 1, "sharded_solve_block": 1}, moved
                n_checks += 2
    log(f"kernel checks: {n_checks} kt_cube_fused and kt_group_solve cases bit-identical to the plain "
        f"versions, one launch per call on the card")


def random_core_inputs(rng, cap, n, g, dev):
    """A resident core matrix, n fresh rows for distinct slots edge-padded
    to a multiple of 8 (duplicate slots, equal rows), and a gather order of
    g groups edge-padded to the pow2 rung with its counts."""
    core = np.stack([rng.randint(0, 1008, size=cap), rng.randint(0, 2, size=cap),
                     rng.randint(0, 200, size=cap)], axis=1).astype(np.int32)
    slots = rng.permutation(cap)[:n].astype(np.int32)
    rows = np.stack([rng.randint(0, 1008, size=n), rng.randint(0, 2, size=n),
                     rng.randint(0, 200, size=n)], axis=1).astype(np.int32)
    pad = (8 - n % 8) % 8
    slots = np.pad(slots, (0, pad), mode="edge")
    rows = np.pad(rows, ((0, pad), (0, 0)), mode="edge")
    gb = max(8, 1 << (g - 1).bit_length())
    order = np.pad(rng.randint(0, cap, size=g).astype(np.int32), (0, gb - g), mode="edge")
    counts = np.pad(rng.randint(0, 1000, size=g).astype(np.int32), (0, gb - g))
    return tuple(_to(a, dev) for a in (core, slots, rows, order, counts))


def _to(a: np.ndarray, dev) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


# -- the bench workload in the port's API --------------------------------------


def build_catalog():
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.cloudprovider.types import InstanceType

    catalog = construct_instance_types()
    base = list(catalog)
    for r in range(1, CATALOG_REPEAT):
        for it in base:
            catalog.append(
                InstanceType(
                    name=f"{it.name}-r{r}",
                    requirements=it.requirements,
                    offerings=it.offerings,
                    capacity=it.capacity,
                    overhead=it.overhead,
                )
            )
    return catalog


def bench_shapes():
    """The bench's 200 pod shapes (node selector, requests) and the shape
    of each of its NUM_PODS pods, drawn with RandomState(7)."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    rng = np.random.RandomState(7)
    zones = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
    archs = ["amd64", "arm64"]
    cpus = ["100m", "250m", "500m", "1", "2", "4"]
    mems = ["128Mi", "256Mi", "512Mi", "1Gi", "2Gi", "4Gi"]
    shapes = []
    for _ in range(200):
        sel = {}
        roll = rng.rand()
        if roll < 0.3:
            sel[wk.LABEL_ARCH] = archs[rng.randint(2)]
        if roll < 0.15:
            sel[wk.LABEL_TOPOLOGY_ZONE] = zones[rng.randint(4)]
        if roll > 0.8:
            sel[wk.CAPACITY_TYPE_LABEL_KEY] = wk.CAPACITY_TYPE_SPOT
        requests = parse_resource_list(
            {"cpu": cpus[rng.randint(len(cpus))], "memory": mems[rng.randint(len(mems))]}
        )
        shapes.append((sel, requests))
    return shapes, rng.randint(len(shapes), size=NUM_PODS)


def _pending_pod(name, uid, sel, requests, ts):
    from karpenter_tpu_torch.apis.core import Condition, Container, ObjectMeta, Pod, PodSpec

    pod = Pod(
        metadata=ObjectMeta(name=name, uid=uid),
        spec=PodSpec(node_selector=dict(sel), containers=[Container(requests=dict(requests))]),
    )
    pod.metadata.creation_timestamp = ts
    pod.status.conditions.append(Condition(type="PodScheduled", status="False", reason="Unschedulable"))
    return pod


def build_pods():
    shapes, picks = bench_shapes()
    return [
        _pending_pod(f"pod-{i:05d}", f"uid-{i:05d}", *shapes[s], float(i % 13))
        for i, s in enumerate(picks)
    ]


def churn_pods(k: int):
    """Churn pass k's new pods: CHURN_PODS pods of the workload's
    last-sorting shape (least cpu, then least memory, among the shapes its
    pods use), created after every earlier pod with later uids, so they
    extend the FFD stream as an exact suffix."""
    from karpenter_tpu_torch.apis import labels as wk

    shapes, picks = bench_shapes()
    last = min(set(picks.tolist()),
               key=lambda s: (shapes[s][1][wk.RESOURCE_CPU], shapes[s][1][wk.RESOURCE_MEMORY], s))
    return [
        _pending_pod(f"churn-{k:02d}-{j:03d}", f"uid-churn-{k:02d}-{j:03d}", *shapes[last], 100.0 + k)
        for j in range(CHURN_PODS)
    ]


def packer_workload(engine):
    """The bench workload as the group solver's input: one Requirements
    object per shape (its node selector), repeated by identity, and the
    [NUM_PODS, D] requests (cpu, memory, one pod)."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.scheduling.requirements import Requirements

    shapes, picks = bench_shapes()
    reqs = [Requirements.from_labels(sel) for sel, _ in shapes]
    dims = engine.resource_dims
    per_shape = np.zeros((len(shapes), len(dims)))
    for k, (_, requests) in enumerate(shapes):
        per_shape[k, dims[wk.RESOURCE_CPU]] = requests[wk.RESOURCE_CPU]
        per_shape[k, dims[wk.RESOURCE_MEMORY]] = requests[wk.RESOURCE_MEMORY]
    per_shape[:, dims[wk.RESOURCE_PODS]] = 1.0
    return [reqs[s] for s in picks], per_shape[picks]


def small_case(kind: str) -> dict:
    """A small solve of the bench's pod shapes on the kwok catalog: `plain`
    (one pool), `nodes` (plus existing nodes with seeded usage), `limits`
    (plus a preferred second NodePool with a cpu limit: two templates) or
    `both`."""
    pools = [{"name": "default", "weight": 10, "limits": None}]
    if kind in ("limits", "both"):
        pools.append({"name": "capped", "weight": 50, "limits": {"cpu": "300"}})
    nodes = []
    if kind in ("nodes", "both"):
        rng = np.random.RandomState(11)
        for i in range(24):
            cpu, mem = [("16", "64Gi"), ("32", "128Gi"), ("8", "32Gi")][rng.randint(3)]
            nodes.append({
                "name": f"existing-{i}", "pool": "default",
                "zone": f"kwok-zone-{rng.randint(1, 5)}", "arch": ["amd64", "arm64"][rng.randint(2)],
                "capacity": {"cpu": cpu, "memory": mem, "pods": "110"},
                "used": [["500m", "1", "2"][rng.randint(3)] for _ in range(rng.randint(0, 4))],
            })
    return {"pools": pools, "nodes": nodes}


def _register_nodes(store, cluster, nodes):
    """Existing nodes (and the pods bound to them) into the store and the
    cluster state, as the informer would. Each node carries one value for
    every key a bench pod selects on."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.core import (
        Condition, Container, Node, NodeSpec, NodeStatus, ObjectMeta, Pod, PodSpec,
    )
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    for n in nodes:
        cap = parse_resource_list(n["capacity"])
        node = Node(
            metadata=ObjectMeta(name=n["name"], labels={
                wk.NODEPOOL_LABEL_KEY: n["pool"], wk.LABEL_INSTANCE_TYPE: "s-4x-amd64-linux",
                wk.LABEL_TOPOLOGY_ZONE: n["zone"], wk.LABEL_ARCH: n["arch"],
                wk.LABEL_OS: "linux", wk.CAPACITY_TYPE_LABEL_KEY: "on-demand",
                wk.NODE_REGISTERED_LABEL_KEY: "true", wk.NODE_INITIALIZED_LABEL_KEY: "true",
                wk.LABEL_HOSTNAME: n["name"],
            }),
            spec=NodeSpec(provider_id=f"kwok://{n['name']}"),
            status=NodeStatus(capacity=cap, allocatable=dict(cap)),
        )
        store.create(node)
        cluster.update_node(node)
        for j, cpu in enumerate(n["used"]):
            pod = Pod(
                metadata=ObjectMeta(name=f"{n['name']}-used-{j}", uid=f"{n['name']}-used-{j}"),
                spec=PodSpec(node_name=n["name"],
                             containers=[Container(requests=parse_resource_list({"cpu": cpu}))]),
            )
            pod.metadata.creation_timestamp = 0.0
            pod.status.conditions.append(Condition(type="PodScheduled", status="True"))
            store.create(pod)
            cluster.update_pod(pod)


def solve(engine, catalog, pods, case=None):
    from karpenter_tpu_torch.apis.core import ObjectMeta
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.events.recorder import Recorder
    from karpenter_tpu_torch.runtime.store import Store
    from karpenter_tpu_torch.scheduler.scheduler import Scheduler
    from karpenter_tpu_torch.scheduler.topology import Topology
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.utils.clock import FakeClock
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    case = case or {"pools": [{"name": "default", "weight": None, "limits": None}], "nodes": []}
    clock = FakeClock()
    store = Store(clock=clock)
    cluster = Cluster(clock, store, cloud_provider=None)
    pools = []
    for spec in sorted(case["pools"], key=lambda p: -(p["weight"] or 0)):
        pool = NodePool(metadata=ObjectMeta(name=spec["name"]))
        if spec["weight"] is not None:
            pool.spec.weight = spec["weight"]
        if spec["limits"]:
            pool.spec.limits = parse_resource_list(spec["limits"])
        pool.set_condition("Ready", "True")
        store.create(pool)
        pools.append(pool)
    _register_nodes(store, cluster, case["nodes"])
    state_nodes = cluster.state_nodes()
    its = {pool.metadata.name: catalog for pool in pools}
    t0 = time.perf_counter()
    topology = Topology(store, cluster, state_nodes, pools, its, pods)
    scheduler = Scheduler(
        store, pools, cluster, state_nodes, topology, its, [], Recorder(clock=clock), clock,
        engine=engine,
    )
    results = scheduler.solve(pods)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return results, (time.perf_counter() - t0) * 1000.0


def decisions(results):
    claims = sorted(
        (
            tuple(sorted(p.metadata.uid for p in nc.pods)),
            tuple(sorted(it.name for it in nc.instance_type_options)),
            tuple(
                sorted(
                    (r.key, r.complement, tuple(sorted(r.values)), r.greater_than,
                     r.less_than, r.min_values)
                    for r in nc.requirements
                )
            ),
        )
        for nc in results.new_node_claims
    )
    errors = sorted((p.metadata.uid, str(e)) for p, e in results.pod_errors.items())
    joins = sorted(
        (en.name(), tuple(sorted(p.metadata.uid for p in en.pods)))
        for en in results.existing_nodes if en.pods
    )
    return claims, errors, joins


# -- timing --------------------------------------------------------------------


def cuda_ms(fn, reps=20, warmup=3, rounds=5) -> float:
    """Milliseconds per call: CUDA events around `reps` back-to-back calls,
    median over `rounds`, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def cube_f32(membership, req_compat, offer_compat, custom_need, key_present, available, owner):
    """The JAX package's f32 formulation of the cube (four matmuls), as the
    PyTorch yardstick; never called by the port."""
    m = membership.float()
    compat = (m @ (~req_compat).float()) < 0.5
    offer_rows_ok = (m @ (~offer_compat).float()) < 0.5
    undef_ok = ((custom_need.float() @ (~key_present).float().T) < 0.5).T
    offer_ok = offer_rows_ok & undef_ok & available[None, :]
    onehot = torch.zeros((owner.shape[0], req_compat.shape[1]), device=owner.device)
    onehot[torch.arange(owner.shape[0], device=owner.device), owner.long()] = 1.0
    return compat, (offer_ok.float() @ onehot) > 0.5


# -- phases --------------------------------------------------------------------


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}"
    )


def phase_build():
    from karpenter_tpu_torch import device

    t0 = time.perf_counter()
    libs = device.build_kernels()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc seconds {json.dumps({k: round(v, 2) for k, v in device.BUILD_SECONDS.items()})})")
    for name, text in device.BUILD_LOG.items():
        for line in text.splitlines():
            if ("registers" in line or "error" in line.lower() or "spill" in line
                    or "entry function" in line):
                log(f"  {name}: {line.strip()}")
    PTXAS.update(ptxas_report(device.BUILD_LOG.get("scan", ""), SCAN_KERNELS))
    GROUP_PTXAS.update(ptxas_report(device.BUILD_LOG.get("packer", ""), ["group_solve_kernel"]))
    log(f"ptxas group_solve_kernel: {json.dumps(GROUP_PTXAS)}")
    FEAS_PTXAS.update(ptxas_report(device.BUILD_LOG.get("feasibility", ""), FEAS_KERNELS))
    log(f"ptxas {', '.join(FEAS_KERNELS)}: {json.dumps(FEAS_PTXAS)}")
    for fn, rep in PTXAS.items():
        log(f"ptxas {fn}: {json.dumps(rep)}")
    assert any("resident" in fn for fn in PTXAS) and any("resident" not in fn for fn in PTXAS), \
        f"ptxas reported no scan kernel of one design: {sorted(PTXAS)}"
    assert all(any(k in fn for fn in FEAS_PTXAS) for k in FEAS_KERNELS), \
        f"ptxas reported no {' or '.join(FEAS_KERNELS)}: {sorted(FEAS_PTXAS)}"


def ptxas_report(text: str, names) -> dict:
    """Registers, shared memory (bytes, static), stack and spills per
    compiled function whose mangled name holds one of `names`, from
    `nvcc -Xptxas -v` output."""
    import re

    out, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([A-Za-z0-9_]+)", line)
        if m:
            fn = m.group(1) if any(n in m.group(1) for n in names) else None
            if fn:
                out.setdefault(fn, {})
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[fn]["smem_static"] = int(s.group(1)) if s else 0
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def check_equal(name: str, got, want) -> None:
    """Bit for bit: same dtype and shape, float64 compared as raw bits."""
    if got is not None and not isinstance(got, tuple) and got.is_cuda:
        torch.cuda.synchronize()
    if isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            check_equal(f"{name}[{i}]", g, w)
        return
    want = want.to(got.device)  # a replica on another card than its reference
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(_bits(got), _bits(want)):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel disagrees with plain version ({bad} cells)")


def random_uid_inputs(rng, lead, U, I, dev):
    """A [U, I] one-hot of a random uid_of_type covering every uid, and a
    random [*lead, I] type mask."""
    uid_of_type = np.concatenate([np.arange(U), rng.randint(0, U, size=I - U)])
    rng.shuffle(uid_of_type)
    onehot = np.zeros((U, I), dtype=bool)
    onehot[uid_of_type, np.arange(I)] = True
    return _to(onehot, dev), _to(rng.rand(*lead, I) < 0.3, dev)


# uid_project_factored's phase-3 shapes: T x F x U x I over these, then the
# workload's famu_ok (T=1, F=64, U=36, I=1008)
FAMU_SHAPES = tuple(itertools.product((1, 2, 4), (1, 7, 64), (1, 33, 70), (1, 31, 1008))) + (
    (1, 64, 36, 1008),)


def random_famu_inputs(rng, T, F, U, I, dev):
    """famu_ok's factored operands: a [U, I] one-hot of a random
    uid_of_type (each uid owning a type while there are types for it),
    tmpl_mask [T, I] and sparse fam_mask [F, I], the last template row and
    the first family row all-false when there are two or more."""
    uid_of_type = rng.randint(0, U, size=I)
    k = min(U, I)
    uid_of_type[rng.permutation(I)[:k]] = rng.permutation(U)[:k]
    onehot = np.zeros((U, I), dtype=bool)
    onehot[uid_of_type, np.arange(I)] = True
    tmpl, fam = rng.rand(T, I) < 0.6, rng.rand(F, I) < 0.08
    if T > 1:
        tmpl[-1] = False
    if F > 1:
        fam[0] = False
    return _to(onehot, dev), _to(tmpl, dev), _to(fam, dev)


def famu_checks(rng, dev) -> int:
    """uid_project_factored at FAMU_SHAPES, bit for bit against the plain
    product and one launch a call; the masks also as row ranges of one
    buffer (the fused solve's one upload) and one byte past 16-byte
    alignment (the kernel's byte path). Returns the cases checked."""
    from karpenter_tpu_torch.ops import feasibility as feas

    n = 0
    for T, F, U, I in FAMU_SHAPES:
        onehot, tmpl, fam = random_famu_inputs(rng, T, F, U, I, dev)
        want = feas.uid_project_factored_plain(onehot, tmpl, fam)
        label = f"T={T} F={F} U={U} I={I}"
        l0 = dict(_count_launches())
        got = feas.uid_project_factored(onehot, tmpl, fam)
        moved = {k: v - l0[k] for k, v in _count_launches().items() if v != l0[k]}
        assert moved == {"uid_project": 1}, f"uid_project_factored {label}: launches {moved}"
        check_equal(f"uid_project_factored {label}", got, want)
        buf = torch.cat([onehot, fam, tmpl])
        check_equal(f"uid_project_factored {label} (one buffer)",
                    feas.uid_project_factored(buf[:U], buf[U + F:], buf[U:U + F]), want)
        flat = torch.zeros(buf.numel() + 1, dtype=torch.bool, device=dev)
        flat[1:] = buf.view(-1)
        odd = flat[1:].view(buf.shape)
        check_equal(f"uid_project_factored {label} (unaligned)",
                    feas.uid_project_factored(odd[:U], odd[U + F:], odd[U:U + F]), want)
        n += 3
    return n


def capture_scan(engine, catalog, pods, case=None):
    """Solve with the fused scan forced on; returns the (cfg, operands) the
    scan got, the results and the wall ms."""
    from karpenter_tpu_torch.ops import fused, packer

    seen = []
    real, mode = packer.solve_scan, fused.FUSED_MODE

    def shim(cfg, args):
        seen.append((cfg, args))
        return real(cfg, args)

    packer.solve_scan, fused.FUSED_MODE = shim, "on"
    try:
        results, ms = solve(engine, catalog, copy.deepcopy(pods), case)
    finally:
        packer.solve_scan, fused.FUSED_MODE = real, mode
    assert len(seen) == 1, f"the fused scan ran {len(seen)} times"
    return seen[0], results, ms


def phase_kernel_checks(dev=torch.device("cuda")):
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    rng = np.random.RandomState(0)
    n = 0
    for R, N, K, W in ((128, 1008, 8, 8), (128, 8064, 8, 8), (1, 1, 8, 2), (37, 45, 8, 2),
                       (70, 1000, 16, 4), (3, 8064, 8, 8)):
        for bounded, complement in ((0.0, 0.0), (0.3, 0.5)):
            args = random_row_inputs(rng, R, N, K, W, dev, bounded, complement)
            check_equal(f"row_compat R={R} N={N} K={K} W={W} bounded={bounded}",
                        feas.req_rows_vs_sets(*args), feas.req_rows_vs_sets_plain(*args))
            n += 1
    for P, R, I, O, K in ((256, 64, 1008, 8064, 8), (256, 128, 1008, 8064, 8), (1, 1, 1, 1, 8),
                          (1, 33, 37, 75, 8), (45, 70, 1000, 3001, 40), (33, 1, 5, 9, 8)):
        args = random_cube_inputs(rng, P, R, I, O, K, dev)
        check_equal(f"membership P={P} R={R} N={I}",
                    feas.membership_all(args[0], args[1]),
                    feas.membership_all_plain(args[0], args[1]))
        check_equal(f"cube P={P} R={R} I={I} O={O} K={K}",
                    feas.production_cube(*args), feas.production_cube_plain(*args))
        n += 2
    for lead, U, I in (((1, 64), 36, 1008), ((7,), 1, 1), ((3, 5), 1, 77), ((2, 9), 40, 1001),
                       ((1,), 33, 33), ((300,), 5, 7)):
        onehot, mask = random_uid_inputs(rng, lead, U, I, dev)
        check_equal(f"uid_project lead={lead} U={U} I={I}",
                    feas.uid_project(onehot, mask), feas.uid_project_plain(onehot, mask))
        n += 1
    n += famu_checks(rng, dev)
    for R, sizes, K, W in TARGET_CHECK_SHAPES:
        for bounded, complement in ((0.0, 0.0), (0.3, 0.5)):
            rows, targets, sk, vi = random_target_inputs(rng, R, sizes, K, W, dev, bounded, complement)
            want = torch.cat([feas.req_rows_vs_sets_plain(*rows, *t, sk, vi) for t in targets], dim=1)
            label = f"R={R} N={sizes} K={K} W={W} bounded={bounded}"
            table = feas.row_table(*rows)
            check_equal(f"req_rows_vs_targets {label}", feas.req_rows_vs_targets(table, targets, sk, vi),
                        want)
            packs = [feas.pack_sets(*t) for t in targets]
            check_equal(f"req_rows_vs_targets_plain {label}", feas.req_rows_vs_targets_plain(
                table, packs, feas.key_slot_words(sk, K), vi), want)
            n += 2
    for P, R, Rtot, I, O, K in SWEEP_CHECK_SHAPES:
        args = random_sweep_inputs(rng, P, R, Rtot, I, O, K, dev)
        check_equal(f"cube_rows P={P} R={R} of {Rtot} I={I} O={O} K={K}", feas.cube_rows(*args),
                    feas.cube_rows_plain(*args))
        n += 1
    log(f"kernel checks: {n} feasibility and uid_project cases (the factored form at "
        f"{len(FAMU_SHAPES)} shapes) bit-identical to the plain versions")
    n = 0
    for P, R, O, K, I in ((256, 64, 8064, 8, 1008), (200, 16, 8064, 0, 1008), (1, 1, 1, 0, 1),
                          (33, 3, 75, 8, 37), (45, 70, 3001, 40, 1000), (7, 33, 20, 0, 9)):
        args = random_offering_inputs(rng, P, R, O, K, I, dev)
        check_equal(f"offering_reduce P={P} R={R} O={O} K={K} I={I}",
                    feas.offering_reduce(*args, I), feas.offering_reduce_plain(*args, I))
        n += 1
    for shape in GROUP_CHECK_SHAPES:
        n += group_mode_checks(rng, *shape, dev)
    for cap, m, g in ((256, 200, 200), (64, 1, 1), (1024, 517, 1000), (16384, 256, 250)):
        core, slots, rows, order, counts = random_core_inputs(rng, cap, m, g, dev)
        got = packer.delta_scatter_rows(core.clone(), slots, rows)
        want = packer.delta_scatter_rows_plain(core.clone(), slots, rows)
        check_equal(f"delta_scatter cap={cap} n={m}", got, want)
        check_equal(f"delta_finalize cap={cap} G={g}", packer.delta_finalize(got, order, counts),
                    packer.delta_finalize_plain(want, order, counts))
        n += 2
    log(f"kernel checks: {n} offering_reduce, kt_group_solve (finalize, core, scatter and pass modes; R "
        f"and K past 2048, I past a chunk of types, offerings past a window) and delta_scatter/finalize "
        f"cases bit-identical to the plain versions, one launch per call")
    sharded_kernel_checks(dev)
    catalog = construct_instance_types()
    pods = build_pods()[:SMALL_PODS]
    d0 = {k: packer.LAUNCHES[k] for k in ("scan_resident", "scan_global")}
    plain_case = None
    for kind, want_cfg in (("plain", (1, False, False)), ("nodes", (1, True, False)),
                           ("limits", (2, False, True)), ("both", (2, True, True))):
        engine = CatalogEngine(catalog, device=dev)
        (cfg, args), _, _ = capture_scan(engine, catalog, pods, small_case(kind))
        assert tuple(cfg) == want_cfg, f"{kind}: scan variant {cfg}, expected {want_cfg}"
        assert packer.scan_design(cfg, args) == "resident", f"{kind}: the resident set does not fit"
        check_resident_bytes(cfg, args)
        plain_case = plain_case or (cfg, args)
        n_pods = int(args[13])
        want = packer.solve_scan_full_plain(cfg, args)
        # resume from the full state of the first 3/4 of the pods
        p_lo = n_pods * 3 // 4
        pre = list(args)
        pre[0] = args[0].clone()
        pre[0][p_lo:] = -1
        pre[13] = torch.full_like(args[13], p_lo)
        st_p = packer.solve_scan_full_plain(cfg, tuple(pre))[:-1]
        head, tail, stop, abort = (int(v) for v in st_p[0][:4].cpu())
        extendable = abort == packer.SCAN_OK and not stop and head == tail == p_lo
        assert extendable, f"{kind}: the {p_lo}-pod prefix requeued, so no resume is sound"
        res_p = packer.solve_scan_resume_plain(cfg, args, tuple(t.clone() for t in st_p), p_lo)
        for design in ("resident", "global"):
            force = None if design == "resident" else design
            check_equal(f"solve_scan {kind} ({design})", tuple(packer.solve_scan(cfg, args, _design=force)),
                        packer._scan_finals(want[:-1]) + (want[-1],))
            full = packer.solve_scan_full(cfg, args, _design=force)
            check_equal(f"solve_scan_full {kind} ({design})", tuple(full), tuple(want))
            st_k = packer.solve_scan_full(cfg, tuple(pre), _design=force)[:-1]
            check_equal(f"solve_scan_full {kind} prefix ({design})", tuple(st_k), tuple(st_p))
            res_k = packer.solve_scan_resume(cfg, args, st_k, p_lo, _design=force)
            check_equal(f"solve_scan_resume {kind} ({design})", tuple(res_k), tuple(res_p))
            check_equal(f"solve_scan_resume {kind} == solve_scan_full on the whole list ({design})",
                        (res_k[0][:7],) + tuple(res_k[1:-1]), (full[0][:7],) + tuple(full[1:-1]))
        pod_seq = want[5][:n_pods]
        log(f"solve_scan {kind} cfg={cfg}: {n_pods} pods, abort {int(want[0][3])}, "
            f"{int(want[0][6])} claims, {int((pod_seq >= 0).sum())} placed, "
            f"{int((want[4] >= 0).sum())} node joins, {int(want[-1])} steps: in both designs the 10 "
            f"outputs, the full state (23 components) and the resume from {p_lo} pods "
            f"({int(res_k[-1])} steps) bit-identical; resume == full solve of the whole list")
    # past the budget: the plain solve with a claim axis of 8192 slots
    cfg, args = plain_case
    wide = (args[0], torch.zeros(8192, dtype=args[1].dtype, device=dev)) + tuple(args[2:])
    assert packer.scan_design(cfg, wide) == "global", "a claim axis of 8192 still fits the resident set"
    check_resident_bytes(cfg, wide)
    g0 = packer.LAUNCHES["scan_global"]
    check_equal("solve_scan with 8192 claim slots", tuple(packer.solve_scan(cfg, wide)),
                tuple(packer.solve_scan_plain(cfg, wide)))
    assert packer.LAUNCHES["scan_global"] == g0 + 1, "the past-budget solve did not take the global design"
    moved = {k: packer.LAUNCHES[k] - v for k, v in d0.items()}
    # per variant: its capture's solve, then four launches in each design
    assert moved == {"scan_resident": 4 * 5, "scan_global": 4 * 4 + 1}, moved
    log(f"kernel checks: scan launches by design {json.dumps(moved)}; 8192 claim slots need "
        f"{packer.scan_resident_bytes(packer._scan_dims(cfg, wide))} bytes of shared memory: global design")


def check_resident_bytes(cfg, args) -> None:
    """ops/packer.py's count of the resident set's bytes equals the
    kernel's own (csrc/scan.cu res_layout) for these operands' dims."""
    from karpenter_tpu_torch.ops import packer

    d = packer._scan_dims(cfg, args)
    got, want = packer.scan_resident_bytes(d), packer.scan_resident_bytes_kernel(d)
    assert got == want, f"scan_resident_bytes {got} != the kernel's {want} for {d}"


def fits_stage_checks(captured, dev=torch.device("cuda")):
    """B4 (fits_matrix, int32 and float32) and B7 (stage_plane) against
    their plain versions, bit for bit, on random inputs with zero
    capacities and ragged shapes. Their launches here and in
    fits_stage_entries' workload checks are their only ones."""
    from karpenter_tpu_torch.ops import feasibility as feas

    rng = np.random.RandomState(2)
    n0 = {k: feas.LAUNCHES[k] for k in ("fits_matrix", "stage_plane")}
    n = 0
    for P, I, D in ((1, 1, 1), (37, 1008, 4), (256, 1008, 4), (5, 33, 6), (300, 7, 0), (70000, 9, 4),
                    (9, 40, 11), (2049, 300, 8)):
        for dtype in (np.int32, np.float32):
            alloc = rng.randint(0, 8, size=(I, D)).astype(dtype)
            alloc[rng.rand(I, D) < 0.2] = 0
            req = rng.randint(0, 8, size=(P, D)).astype(dtype)
            req[rng.rand(P, D) < 0.3] = 0
            if dtype == np.float32:
                req += rng.choice([0.0, 0.25, -0.5], size=(P, D)).astype(np.float32)
            r, a = _to(req, dev), _to(alloc, dev)
            check_equal(f"fits_matrix {np.dtype(dtype).name} P={P} I={I} D={D}",
                        feas.fits_matrix(r, a), feas.fits_matrix_plain(r, a))
            n += 1
    for shape in ((1,), (7, 1008), (256, 1008), (3, 5, 77), (1 << 20,)):
        planes = [_to(rng.rand(*shape) < q, dev) for q in (0.8, 0.7, 0.6)]
        check_equal(f"stage_plane {shape}", feas.stage_plane(*planes), feas.stage_plane_plain(*planes))
        n += 1
    captured["phase3_launches"] = {k: feas.LAUNCHES[k] - n0[k] for k in n0}
    log(f"kernel checks: {n} fits_matrix and stage_plane cases bit-identical to the plain "
        f"versions; launches {json.dumps(captured['phase3_launches'])}")


def assert_resident(launches, label) -> None:
    """Every scan launch the phase counted took the resident design."""
    scans = launches["solve_scan"] + launches["solve_scan_full"] + launches["solve_scan_resume"]
    assert scans > 0 and launches["scan_resident"] == scans and launches["scan_global"] == 0, \
        f"{label}: {scans} scan launches, {launches['scan_resident']} resident, " \
        f"{launches['scan_global']} global"
    log(f"{label}: all {scans} scan launches took the resident design")


def _count_launches():
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    return {**feas.LAUNCHES, **packer.LAUNCHES}


def phase_main(captured, device=None):
    """The main path (the scan at `auto` on a CUDA engine), then the
    slice-1 path (scan off, the native walk) on the same workload."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import ffd, fused, native, packer
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    catalog = build_catalog()
    pods = build_pods()
    engine = CatalogEngine(catalog, device=device)  # None: the current CUDA device
    log(f"workload: {engine.num_instances} types, {engine.num_offerings} offerings, "
        f"{len(pods)} pods, engine on {engine.device}, fused mode {fused.FUSED_MODE!r}")
    assert fused.fused_enabled(engine), "the fused scan is not on for this engine"

    # record the largest inputs each kernel sees on the main path, to time
    # the kernels on them afterwards (recording does not launch anything);
    # count the engine's row batches and sweeps (one call of its entry
    # each) and the sweeps' shapes, on both paths
    real = (feas.req_rows_vs_targets, feas.cube_rows, feas.uid_project_factored, packer.solve_scan)
    recording = [True]
    calls = {"row_batches": 0, "sweeps": 0}
    shapes: dict = {}

    def keep(name, args, size):
        if recording[0] and (name not in captured or size(args) >= size(captured[name])):
            captured[name] = args

    def rows_shim(*args):
        keep("row_compat", args, lambda a: a[0].shape[0])
        calls["row_batches"] += 1
        return real[0](*args)

    def cube_shim(*args):
        keep("cube", args, lambda a: a[0].shape[0] * a[2].shape[0])
        calls["sweeps"] += 1
        if recording[0]:
            # entities (padded), rows used, membership columns (padded)
            shape = f"P={args[0].shape[0]} R={args[2].shape[0]} R2={args[0].shape[1]}"
            shapes[shape] = shapes.get(shape, 0) + 1
        return real[1](*args)

    def uid_shim(*args):
        keep("uid_project", args, lambda a: a[1].shape[0] * a[2].shape[0])
        return real[2](*args)

    def scan_shim(cfg, args):
        captured["solve_scan"] = (cfg, args)
        return real[3](cfg, args)

    native_runs = []
    real_drive = ffd._NativeDriver.drive

    def drive_shim(self):
        native_runs.append(1)
        return real_drive(self)

    mode0 = fused.FUSED_MODE
    feas.req_rows_vs_targets, feas.cube_rows, feas.uid_project_factored, packer.solve_scan = (
        rows_shim, cube_shim, uid_shim, scan_shim)
    ffd._NativeDriver.drive = drive_shim
    try:
        solves0, fused0, declines0 = ffd.DEVICE_SOLVES, fused.FUSED_SOLVES, dict(fused.FUSED_DECLINES)
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        runs = []
        for label in ("cold", "warm", "warm"):
            before, c0 = _count_launches(), dict(calls)
            results, ms = solve(engine, catalog, copy.deepcopy(pods))
            runs.append((label, ms, results,
                         {k: v - before[k] for k, v in _count_launches().items()},
                         {k: v - c0[k] for k, v in calls.items()}))
        launches = _count_launches()
        scan_calls = dict(calls)
        fused_solves = fused.FUSED_SOLVES - fused0
        declines = {k: v - declines0.get(k, 0) for k, v in fused.FUSED_DECLINES.items()
                    if v != declines0.get(k, 0)}
        scan_native = len(native_runs)
        # the slice-1 path: the walk, cold on a fresh engine and warm, with
        # its own launch and call counts (nothing recorded: the timed
        # inputs stay the scan path's)
        recording[0] = False
        fused.FUSED_MODE = "off"
        walk_engine = CatalogEngine(catalog, device=device)
        walk_runs = []
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        calls.update(row_batches=0, sweeps=0)
        for label, eng in (("cold", walk_engine), ("warm", walk_engine)):
            results, ms = solve(eng, catalog, copy.deepcopy(pods))
            walk_runs.append((label, ms, results))
        walk_launches = _count_launches()
        walk_calls = dict(calls)
    finally:
        fused.FUSED_MODE = mode0
        feas.req_rows_vs_targets, feas.cube_rows, feas.uid_project_factored, packer.solve_scan = real
        ffd._NativeDriver.drive = real_drive
    for label, ms, results, per_solve, per_calls in runs:
        placed = sum(len(nc.pods) for nc in results.new_node_claims)
        log(f"solve {label} (scan): {ms:.1f} ms wall, {len(results.new_node_claims)} nodeclaims, "
            f"{placed} pods placed, {len(results.pod_errors)} pod errors, "
            f"launches {json.dumps({k: v for k, v in per_solve.items() if v})}, "
            f"engine calls {json.dumps(per_calls)}")
        # one kt_row_compat launch a row batch (types and offerings together)
        # and one kt_cube launch a sweep, no kt_membership
        assert per_solve["row_compat"] == per_calls["row_batches"] and \
            per_solve["cube"] == per_calls["sweeps"] and per_solve["membership"] == 0, \
            f"{label}: launches {per_solve}, engine calls {per_calls}"
        # famu_ok: one kt_uid_project launch a scan solve
        assert per_solve["uid_project"] == 1, f"{label}: {per_solve['uid_project']} uid_project launches"
    log(f"phase 4 sweep shapes (scan path): {json.dumps(shapes)}; engine calls of the scan solves "
        f"{json.dumps(scan_calls)}, of the walk solves {json.dumps(walk_calls)}")
    log(f"device solves {ffd.DEVICE_SOLVES - solves0}, fused solves {fused_solves}, declines "
        f"{json.dumps(declines)}, native driver runs {scan_native} with the scan and "
        f"{len(native_runs) - scan_native} with it off (library "
        f"{'loaded' if native.get_lib() is not None else 'MISSING'}), "
        f"kernel launches of the scan solves {json.dumps(launches)}, "
        f"of the walk solves {json.dumps(walk_launches)}")
    assert ffd.DEVICE_SOLVES - solves0 == len(runs) + len(walk_runs), "a solve left the device path"
    assert fused_solves == len(runs) and not declines, "a main-path solve left the scan"
    assert scan_native == 0 and len(native_runs) == len(walk_runs), "the walk ran on the wrong path"
    assert launches["solve_scan"] == len(runs), "solve_scan did not launch once per solve"
    assert_resident(launches, "phase 4")
    for name in ("row_compat", "cube", "uid_project"):
        assert launches[name] > 0, f"{name} never launched on the main path"
    assert walk_launches["solve_scan"] == 0, "the scan launched on the walk path"
    for name in ("row_compat", "cube"):
        assert walk_launches[name] > 0, f"{name} never launched on the walk path"
    # B2 runs on neither path: the sweep's compat half is kt_cube's
    assert launches["membership"] == walk_launches["membership"] == 0, "kt_membership launched"
    assert walk_launches["row_compat"] == walk_calls["row_batches"] and \
        walk_launches["cube"] == walk_calls["sweeps"], (walk_launches, walk_calls)
    first = captured["decisions"] = decisions(runs[0][2])
    for label, _, results in [r[:3] for r in runs] + walk_runs:
        claims, errors, _ = decisions(results)
        assert not errors, f"{label}: {len(errors)} pod errors"
        uids = [u for c in claims for u in c[0]]
        assert len(uids) == len(set(uids)) == len(pods), f"{label}: pods placed != pods"
        assert decisions(results) == first, f"{label}: decisions differ from the cold scan solve"
    log("solve wall ms, scan: cold {:.1f} warm {:.1f} {:.1f} | walk: cold {:.1f} warm {:.1f} "
        "(the walk's cold includes building the native walk); decisions identical".format(
            *(r[1] for r in runs), *(r[1] for r in walk_runs)))
    profile_warm_solve(engine, catalog, pods)
    famu_ok_ops(engine, catalog, pods)
    return launches


# the aten ops a famu_ok build may run: views and allocations, which launch
# nothing on the card, and the one upload of the masks
FAMU_VIEW_OPS = {"slice", "view", "alias", "empty", "detach", "lift_fresh", "as_strided"}
FAMU_COPY_OPS = {"_to_copy", "copy_"}


def famu_ok_ops(engine, catalog, pods) -> None:
    """One more warm solve, its famu_ok build (fused._FusedSolve._famu_ok)
    recorded op by op: every aten op it dispatches (a TorchDispatchMode
    around the build) and the kernel launches it counts. It must be the
    masks' one upload and one kt_uid_project launch: no other aten op that
    runs on the card, no elementwise op. Then a profiled warm solve (the
    whole solve: torch.profiler's trace of a short window drops activity,
    PERF.md section 7) must hold no elementwise `&` kernel; its
    uid_project kernels are logged."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils._python_dispatch import TorchDispatchMode

    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import fused

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            on_card = isinstance(out, torch.Tensor) and out.is_cuda
            self.ops.append((func.overloadpacket.__name__, on_card))
            return out

    static = fused._FusedSolve.__dict__["_famu_ok"]
    builds = []

    def shim(*args):
        l0 = feas.LAUNCHES["uid_project"]
        with Record() as rec:
            out = static.__func__(*args)
        builds.append((rec.ops, feas.LAUNCHES["uid_project"] - l0))
        return out

    fused._FusedSolve._famu_ok = staticmethod(shim)
    try:
        solve(engine, catalog, copy.deepcopy(pods))
    finally:
        fused._FusedSolve._famu_ok = static
    assert len(builds) == 1, f"{len(builds)} famu_ok builds in one solve"
    ops, launches = builds[0]
    copies = [op for op, on_card in ops if op in FAMU_COPY_OPS and on_card]
    other = [op for op, _ in ops if op not in FAMU_VIEW_OPS | FAMU_COPY_OPS]
    assert len(copies) == 1 and not other and launches == 1, \
        f"famu_ok build: aten ops {ops}, {launches} uid_project launches"
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve(engine, catalog, copy.deepcopy(pods))
    kernels = {}
    for ev in prof.key_averages():
        if (getattr(ev, "self_device_time_total", 0.0) or 0.0) > 0:
            kernels[ev.key] = kernels.get(ev.key, 0) + ev.count
    ands = [k for k in kernels if "bitwiseand" in k.lower().replace("_", "")]
    uid = {k: v for k, v in kernels.items() if "uid_project_kernel" in k}
    log(f"phase 4 famu_ok build: aten ops {ops}, {launches} kt_uid_project launch; a profiled warm "
        f"solve's uid_project kernels {json.dumps(uid)}, bitwise-and kernels {ands}")
    assert not ands, f"an elementwise & ran in a warm solve: {ands}"


def phase_delta(captured, device=None):
    """Delta solves on the main workload: the fused scan forced on, delta
    on with a self-check every SELF_CHECK_EVERY warm passes. One cold pass,
    CHURN_PASSES passes of CHURN_PODS suffix pods each; counts zeroed just
    before the cold pass and read after the last churn pass. Then the last
    pod list solved with delta off (same decisions) and re-solved 3 times
    warm with the self-check off (flat memory_allocated). Records the last
    churn pass's resume inputs in `captured`."""
    from karpenter_tpu_torch.ops import delta, ffd, fused, packer
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    catalog = build_catalog()
    pods = build_pods()
    engine = CatalogEngine(catalog, device=device)
    cuda = engine.device.type == "cuda"
    mode0, dmode0, every0 = fused.FUSED_MODE, delta.DELTA_MODE, delta.RESOLVE_FULL_EVERY
    real_resume = packer.solve_scan_resume
    passes = []

    def resume_shim(cfg, args, state, p_lo):
        if len(passes) == CHURN_PASSES:  # the last churn pass: keep its inputs
            captured["solve_scan_resume"] = (cfg, args, tuple(t.clone() for t in state), p_lo)
        return real_resume(cfg, args, state, p_lo)

    fused.FUSED_MODE = "on"
    delta.configure(mode="on", resolve_full_every=SELF_CHECK_EVERY)
    delta.invalidate_all("chip-smoke")
    packer.solve_scan_resume = resume_shim
    try:
        c0 = delta.delta_counters()
        fused0, declines0 = fused.FUSED_SOLVES, dict(fused.FUSED_DECLINES)
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        res = delta.scan_residency(engine)
        for k in range(CHURN_PASSES + 1):
            if k:
                pods = pods + churn_pods(k)
            before = _count_launches()
            results, ms = solve(engine, catalog, pods)
            steps = int(res.state[0][7])
            passes.append((res.last_outcome, ms, steps, res.resident_bytes(), results,
                           {n: v - before[n] for n, v in _count_launches().items() if v != before[n]}))
        launches = _count_launches()
        counters = {k: v - c0.get(k, 0) for k, v in delta.delta_counters().items() if v != c0.get(k, 0)}
        fused_solves = fused.FUSED_SOLVES - fused0
        declines = {k: v - declines0.get(k, 0) for k, v in fused.FUSED_DECLINES.items()
                    if v != declines0.get(k, 0)}
        packer.solve_scan_resume = real_resume
        # the same pods with delta off: the classic scan must decide the same
        delta.configure(mode="off")
        off_results, off_ms = solve(engine, catalog, copy.deepcopy(pods))
        # donation check: identical warm re-solves, self-check off
        delta.configure(mode="on", resolve_full_every=0)
        mem, mem_steps = [], []
        for _ in range(3):
            solve(engine, catalog, pods)
            mem_steps.append((res.last_outcome, int(res.state[0][7])))
            mem.append(torch.cuda.memory_allocated() if cuda else None)
    finally:
        packer.solve_scan_resume = real_resume
        fused.FUSED_MODE = mode0
        delta.configure(mode=dmode0, resolve_full_every=every0)
    for k, (outcome, ms, steps, nbytes_res, results, per) in enumerate(passes):
        log(f"delta pass {k} ({'cold' if k == 0 else 'churn'}): {outcome}, {ms:.1f} ms wall, "
            f"{steps} scan steps, {len(results.new_node_claims)} nodeclaims, "
            f"{len(results.pod_errors)} pod errors, resident {nbytes_res} bytes, launches {json.dumps(per)}")
    warm_ms = [p[1] for p in passes[1:]]
    log(f"delta: counters {json.dumps(counters)}, fused solves {fused_solves}, declines "
        f"{json.dumps(declines)}, launches {json.dumps(launches)}")
    log(f"delta: cold {passes[0][1]:.1f} ms, warm p50 {statistics.median(warm_ms):.1f} ms "
        f"(min {min(warm_ms):.1f}, max {max(warm_ms):.1f}) over {len(warm_ms)} churn passes of "
        f"{CHURN_PODS} pods; delta-off solve of the last list {off_ms:.1f} ms; "
        f"re-solves {json.dumps(mem_steps)}, memory_allocated {mem}")
    assert [p[0] for p in passes] == ["cold"] + ["warm"] * CHURN_PASSES, "a churn pass missed the residency"
    assert counters.get("delta_scan_miss", 0) == 1 and counters.get("delta_scan_warm", 0) >= CHURN_PASSES
    checks = counters.get("delta_selfchecks_identical", 0)
    assert checks >= CHURN_PASSES // SELF_CHECK_EVERY >= 2, f"{checks} self-checks"
    assert counters.get("delta_selfchecks_divergent", 0) == 0, "a self-check diverged"
    assert fused_solves == len(passes) and not declines, "a delta pass left the scan"
    assert launches["solve_scan_resume"] == CHURN_PASSES, "solve_scan_resume not once per churn pass"
    assert launches["solve_scan_full"] == 1 + checks and launches["solve_scan"] == 0
    assert_resident(launches, "phase 5")
    assert all(p[2] == CHURN_PODS for p in passes[1:]), "a resume did not run one step per new pod"
    assert len({p[3] for p in passes}) == 1, "residency bytes changed"
    last = decisions(passes[-1][4])
    assert not last[1], "pod errors on the last churn pass"
    assert decisions(off_results) == last, "the last churn pass decided differently from delta off"
    assert all(m == ("warm", 0) for m in mem_steps), f"re-solves {mem_steps}"
    assert len(set(mem)) == 1, f"memory_allocated moved across warm re-solves: {mem}"
    log(f"delta: 1 miss, {CHURN_PASSES} warm resumes of {CHURN_PODS} steps, {checks} identical "
        f"self-checks, decisions equal to delta off, residency {passes[0][3]} bytes, memory flat")
    return launches


# -- phase 5c: the topology-aware driver ----------------------------------------

TOPO_PODS = 20_000  # bench.py's topology leg (topology_bench): 4 zone-spread deployments
TOPO_WARM = 5
TOPO_MIX_PODS = 2_000


def topology_pods():
    """bench.py's topology leg in the port's API: TOPO_PODS pending pods in four
    deployments app-0..3, 1 cpu / 1Gi each, each zone-spread with maxSkew 1
    and DoNotSchedule over a selector on its own app label."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.core import LabelSelector, TopologySpreadConstraint
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    requests = parse_resource_list({"cpu": "1", "memory": "1Gi"})
    pods = []
    for i in range(TOPO_PODS):
        app = f"app-{i % 4}"
        pod = _pending_pod(f"tp-{i:05d}", f"tp-uid-{i:05d}", {}, requests, 0.0)
        pod.metadata.labels = {"app": app}
        pod.spec.topology_spread_constraints = [TopologySpreadConstraint(
            max_skew=1, topology_key=wk.LABEL_TOPOLOGY_ZONE, when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": app}),
        )]
        pods.append(pod)
    return pods


def topology_mix(leg: str):
    """The 2,000-pod mixed case: (pools, build_pods). `topology`: two
    zone-spread deployments (app-0, app-1), a hostname-spread one (app-2),
    one with required pod anti-affinity on hostname (app-3), pods with
    preferred node affinity, plain pods, a tenth of the pods selecting
    arm64; and beside the `default` NodePool (amd64 only) a second pool
    `soft` tainted PreferNoSchedule, which the arm64 pods reach through the
    relax ladder's toleration rung. `relax`: no topology and one untainted
    pool; a quarter of the pods prefer a zone and a quarter require one of
    two node-affinity terms, the first unsatisfiable: the plain driver
    declines the shape and the topology driver's relax ladder serves it."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.core import (
        Affinity, LabelSelector, NodeAffinity, NodeSelectorTerm, PodAffinityTerm,
        PodAntiAffinity, PreferredSchedulingTerm, Taint, TopologySpreadConstraint,
    )
    from karpenter_tpu_torch.utils.resources import parse_resource_list

    zones = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
    cpus = ["250m", "500m", "1", "2"]

    def term(values):
        return NodeSelectorTerm(match_expressions=[
            {"key": wk.LABEL_TOPOLOGY_ZONE, "operator": "In", "values": values}])

    def preferred(i):
        return Affinity(node_affinity=NodeAffinity(preferred=[
            PreferredSchedulingTerm(weight=50, preference=term([zones[i % 4]]))]))

    def spread(key, app):
        return [TopologySpreadConstraint(
            max_skew=1, topology_key=key, when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": app}))]

    def build_pods():
        pods = []
        for i in range(TOPO_MIX_PODS):
            requests = parse_resource_list({"cpu": cpus[i % 4], "memory": "1Gi"})
            kind = i % 10
            sel = {wk.LABEL_ARCH: "arm64"} if leg == "topology" and kind == 9 else {}
            pod = _pending_pod(f"mix-{i:05d}", f"mix-uid-{i:05d}", sel, requests, float(i % 7))
            if leg == "relax":
                if i % 4 == 0:
                    pod.spec.affinity = preferred(i)
                elif i % 4 == 1:
                    pod.spec.affinity = Affinity(node_affinity=NodeAffinity(
                        required=[term(["kwok-zone-9"]), term(zones[:2])]))
            elif kind <= 2:
                app = f"app-{kind % 2}"
                pod.metadata.labels = {"app": app}
                pod.spec.topology_spread_constraints = spread(wk.LABEL_TOPOLOGY_ZONE, app)
            elif kind == 3:
                pod.metadata.labels = {"app": "app-2"}
                pod.spec.topology_spread_constraints = spread(wk.LABEL_HOSTNAME, "app-2")
            elif kind == 4:
                pod.metadata.labels = {"app": "app-3"}
                pod.spec.affinity = Affinity(pod_anti_affinity=PodAntiAffinity(required=[
                    PodAffinityTerm(topology_key=wk.LABEL_HOSTNAME,
                                    label_selector=LabelSelector(match_labels={"app": "app-3"}))]))
            elif kind <= 6:
                pod.spec.affinity = preferred(i)
            pods.append(pod)
        return pods

    if leg == "relax":
        return [("default", None, [], [])], build_pods
    amd64 = [{"key": wk.LABEL_ARCH, "operator": "In", "values": ["amd64"]}]
    soft = [Taint(key="soft", value="lane", effect="PreferNoSchedule")]
    return [("default", 10, amd64, []), ("soft", 5, [], soft)], build_pods


def topology_env(pool_specs):
    """A store, a cluster and the NodePools of `pool_specs` ((name, weight,
    requirements, taints)), in weight order; an empty cluster."""
    from karpenter_tpu_torch.apis.core import ObjectMeta
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.runtime.store import Store
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    store = Store(clock=clock)
    cluster = Cluster(clock, store, cloud_provider=None)
    pools = []
    for name, weight, requirements, taints in sorted(pool_specs, key=lambda p: -(p[1] or 0)):
        pool = NodePool(metadata=ObjectMeta(name=name))
        if weight is not None:
            pool.spec.weight = weight
        pool.spec.template.spec.requirements = list(requirements)
        pool.spec.template.spec.taints = list(taints)
        pool.set_condition("Ready", "True")
        store.create(pool)
        pools.append(pool)
    return clock, store, cluster, pools


def topology_solve(engine, env, catalog, pods):
    """One provisioning pass over `pods` (the same objects every pass, as
    the bench's topology leg): a fresh Topology and Scheduler, the hostname
    placeholders drawn from a fresh counter (they are decision-relevant
    under topology). engine=None is the host loop. (results, wall ms)."""
    from karpenter_tpu_torch.events.recorder import Recorder
    from karpenter_tpu_torch.scheduler import nodeclaim as ncmod
    from karpenter_tpu_torch.scheduler.scheduler import Scheduler
    from karpenter_tpu_torch.scheduler.topology import Topology

    clock, store, cluster, pools = env
    its = {pool.metadata.name: catalog for pool in pools}
    ncmod._hostname_counter = itertools.count(1)
    t0 = time.perf_counter()
    topology = Topology(store, cluster, [], pools, its, pods)
    scheduler = Scheduler(store, pools, cluster, [], topology, its, [], Recorder(clock=clock), clock,
                          engine=engine)
    results = scheduler.solve(pods)
    if engine is not None and engine.device.type == "cuda":
        torch.cuda.synchronize()
    return results, (time.perf_counter() - t0) * 1000.0


def topo_counters() -> dict:
    """The driver's counters: device solves and fallbacks, fused scan solves
    and declines by reason, topology-driver solves."""
    from karpenter_tpu_torch.ops import ffd, ffd_topo, fused

    return {"device_solves": ffd.DEVICE_SOLVES, "device_fallbacks": ffd.DEVICE_FALLBACKS,
            "fused_solves": fused.FUSED_SOLVES, "topo_solves": int(ffd_topo._TOPO_SOLVES_CTR.value()),
            **{f"decline_{k}": v for k, v in fused.FUSED_DECLINES.items()}}


def counters_since(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in topo_counters().items() if v != before.get(k, 0)}


def served_by(moved: dict) -> str:
    """The attempt that served a solve, from its counter deltas."""
    if moved.get("device_solves", 0) != 1:
        return "host loop"
    if moved.get("topo_solves", 0) == 1:
        return "_TopoSolve"
    return "fused scan" if moved.get("fused_solves", 0) == 1 else "_DeviceSolve"


def phase_topology(captured, device=None):
    """The topology-aware driver on the card (ops/ffd_topo.py). bench.py's
    topology leg at its own size (TOPO_PODS zone-spread pods, the kwok
    catalog x7, one NodePool, an empty cluster) on a CUDA engine: one cold
    and TOPO_WARM warm solves, each a device solve on _TopoSolve with one
    `topo` decline of the fused scan, no fallback, no pod error, no scan,
    group or uid_project launch, one kt_row_compat a row batch and one
    kt_cube a sweep (at least one in the cold solve), shapes logged;
    decisions equal in every solve and to a device="cpu" engine's; the row
    batch and the sweep the path gave the kernels held against their plain
    versions. Then the 2,000-pod mixed case, each leg against the host loop
    (engine=None), saying which attempt served it. Keeps the decisions and
    pods for phase 5b's mesh solve."""
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import ffd, fused, packer
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    t_phase = time.perf_counter()
    catalog = build_catalog()
    pods = topology_pods()
    env = topology_env([("default", None, [], [])])
    real = (feas.req_rows_vs_targets, feas.cube_rows, feas.launch, packer.launch,
            ffd._DeviceSolve.run)
    entries: dict = {}  # C entry point -> launches
    calls = {"row_batches": 0, "sweeps": 0}
    shapes: dict = {}
    declined = []
    recording = [True]  # keep the CUDA engine's inputs only

    def keep(name, args, size):
        if recording[0] and (name not in captured or size(args) >= size(captured[name])):
            captured[name] = args

    def launch_shim(dev, entry, *args):
        entries[entry.__name__] = entries.get(entry.__name__, 0) + 1
        return real[2](dev, entry, *args)

    def rows_shim(*args):
        calls["row_batches"] += 1
        keep("topo_row_compat", args, lambda a: a[0].shape[0])
        shape = f"row_compat R={args[0].shape[0]} N={'+'.join(str(t[0].shape[0]) for t in args[1])}"
        shapes[shape] = shapes.get(shape, 0) + 1
        return real[0](*args)

    def cube_shim(*args):
        calls["sweeps"] += 1
        keep("topo_cube", args, lambda a: a[0].shape[0] * (a[2].shape[0] + 1))
        shape = f"cube P={args[0].shape[0]} R={args[2].shape[0]} R2={args[0].shape[1]}"
        shapes[shape] = shapes.get(shape, 0) + 1
        return real[1](*args)

    def run_shim(self, timeout):
        try:
            return real[4](self, timeout)
        except ffd._IneligibleShape:
            declined.append(type(self).__name__)
            raise

    def solve_counted(engine, env_, catalog_, pods_):
        """topology_solve with this solve's counters, launches by C entry,
        engine calls, shapes and the attempts that declined."""
        c0, l0 = topo_counters(), _count_launches()
        entries.clear()
        shapes.clear()
        del declined[:]
        calls.update(row_batches=0, sweeps=0)
        results, ms = topology_solve(engine, env_, catalog_, pods_)
        return results, ms, {
            "counters": counters_since(c0),
            "launches": {k: v - l0[k] for k, v in _count_launches().items() if v != l0[k]},
            "entries": dict(entries), "calls": dict(calls), "shapes": dict(shapes),
            "declined": list(declined),
        }

    feas.req_rows_vs_targets, feas.cube_rows = rows_shim, cube_shim
    feas.launch = packer.launch = launch_shim
    ffd._DeviceSolve.run = run_shim
    try:
        engine = CatalogEngine(catalog, device=device)  # None: the current CUDA device
        on_card = engine.device.type == "cuda"
        log(f"phase 5c: {len(pods)} zone-spread pods in 4 deployments, {engine.num_instances} "
            f"types, {engine.num_offerings} offerings, engine on {engine.device}, fused "
            f"{'on' if fused.fused_enabled(engine) else 'off'}")
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        runs = []
        for k in range(1 + TOPO_WARM):
            label = "cold" if k == 0 else f"warm {k}"
            results, ms, seen = solve_counted(engine, env, catalog, pods)
            runs.append((label, ms, results, seen))
            moved, ent = seen["counters"], seen["entries"]
            log(f"topology solve {label}: {ms:.1f} ms wall, {len(results.new_node_claims)} "
                f"nodeclaims, {len(results.pod_errors)} pod errors, served by {served_by(moved)}, "
                f"counters {json.dumps(moved)}, C launches {json.dumps(ent)}, engine calls "
                f"{json.dumps(seen['calls'])}, shapes {json.dumps(seen['shapes'])}")
            assert served_by(moved) == "_TopoSolve" and not moved.get("device_fallbacks"), \
                f"{label}: not served by the topology driver: {moved}"
            assert not results.pod_errors, f"{label}: {len(results.pod_errors)} pod errors"
            if fused.fused_enabled(engine):
                assert moved.get("decline_topo") == 1, f"{label}: no topo decline: {moved}"
            if on_card:
                assert all(ent.get(e, 0) == 0 for e in ("kt_solve_scan", "kt_group_solve",
                                                        "kt_uid_project", "kt_membership")), ent
                assert ent.get("kt_row_compat", 0) == seen["calls"]["row_batches"] and \
                    ent.get("kt_cube", 0) == seen["calls"]["sweeps"], (ent, seen["calls"])
                assert seen["launches"].get("row_compat", 0) == ent.get("kt_row_compat", 0) and \
                    seen["launches"].get("cube", 0) == ent.get("kt_cube", 0), seen["launches"]
                if k == 0:
                    assert ent.get("kt_cube", 0) >= 1, "no kt_cube launch in the cold solve"
        path_launches = _count_launches()
        first = decisions(runs[0][2])
        for label, _, results, _ in runs:
            assert decisions(results) == first, f"topology solve {label}: decisions differ from cold"
        warm = [r[1] for r in runs[1:]]
        topo = {
            "pods": len(pods), "nodeclaims": len(runs[0][2].new_node_claims),
            "cold_ms": runs[0][1], "warm_ms": warm, "warm_p50_ms": statistics.median(warm),
            "per_solve": [{"solve": label, "ms": ms, "entries": seen["entries"],
                           "calls": seen["calls"], "shapes": seen["shapes"]}
                          for label, ms, _, seen in runs],
            "launches": {k: v for k, v in path_launches.items() if v},
        }
        recording[0] = False
        cpu_results, cpu_ms, cpu_seen = solve_counted(CatalogEngine(catalog, device="cpu"), env,
                                                      catalog, pods)
        assert served_by(cpu_seen["counters"]) == "_TopoSolve", cpu_seen["counters"]
        assert decisions(cpu_results) == first, "the CUDA and CPU engines decided differently"
        topo["cpu_engine_ms"] = cpu_ms
        log(f"topology: {len(pods)} pods, decisions of the {len(runs)} CUDA solves equal to each "
            f"other and to a device=\"cpu\" engine's ({cpu_ms:.1f} ms); warm p50 "
            f"{topo['warm_p50_ms']:.1f} ms, cold {runs[0][1]:.1f} ms")
        captured["topo_decisions"], captured["topo_pods"] = first, pods
        if on_card:
            # one more warm solve, after the counts were read: device busy
            # share and host time by function
            topo["profiled"] = captured["topo_profiled"] = profile_run(
                lambda: topology_solve(engine, env, catalog, pods),
                "profiled warm topology solve", "warm_topology_profile.txt")
        # the kernels at the shapes this path gave them, against their plain
        # versions (these launches are the checks', not the path's)
        if on_card:
            table, targets, sk, vi = captured["topo_row_compat"]
            packs = [feas.pack_sets(*t) for t in targets]
            key_slots = feas.key_slot_words(sk, targets[0][0].shape[1])
            cube = captured["topo_cube"]
            assert table.is_cuda and cube[0].is_cuda, "the topology path's inputs are not on the card"
            checks = {
                "row_compat": (lambda: real[0](table, targets, sk, vi),
                               lambda: feas.req_rows_vs_targets_plain(table, packs, key_slots, vi)),
                "cube": (lambda: real[1](*cube), lambda: feas.cube_rows_plain(*cube)),
            }
            topo["kernels"] = {}
            for name, (kernel, plain) in checks.items():
                check_equal(f"{name} on the topology path", uncounted(kernel), plain())
                topo["kernels"][name] = {"ms": uncounted(cuda_ms, kernel),
                                         "plain_ms": cuda_ms(plain, reps=5, warmup=1)}
            log(f"topology path kernels equal to their plain versions: row_compat "
                f"{list(table.shape)} x {[t[0].shape[0] for t in targets]}, cube "
                f"{[list(cube[i].shape) for i in (0, 2)]}; wrapper and plain ms "
                f"{json.dumps(topo['kernels'])}")
        # the mixed case on the kwok catalog, each leg against the host loop
        small = construct_instance_types()
        mix_engine = CatalogEngine(small, device=device)
        topo["mix"] = {}
        for leg in ("topology", "relax"):
            pool_specs, build = topology_mix(leg)
            host_results, host_ms, host_seen = solve_counted(None, topology_env(pool_specs), small,
                                                             build())
            assert served_by(host_seen["counters"]) == "host loop", host_seen["counters"]
            results, ms, seen = solve_counted(mix_engine, topology_env(pool_specs), small, build())
            moved = seen["counters"]
            got = decisions(results)
            pools_used = sorted({nc.nodepool_name for nc in results.new_node_claims})
            log(f"mixed {leg} ({TOPO_MIX_PODS} pods): host loop {host_ms:.1f} ms, engine "
                f"{ms:.1f} ms, served by {served_by(moved)} after declines {seen['declined']}, "
                f"counters {json.dumps(moved)}, C launches {json.dumps(seen['entries'])}, "
                f"{len(results.new_node_claims)} nodeclaims in pools {pools_used}, "
                f"{len(results.pod_errors)} pod errors")
            assert got == decisions(host_results), f"mixed {leg}: the engine and the host loop differ"
            assert served_by(moved) == "_TopoSolve" and not moved.get("device_fallbacks"), moved
            if leg == "relax":
                assert seen["declined"] == ["_DeviceSolve"], seen["declined"]
            else:
                assert not seen["declined"] and pools_used == ["default", "soft"], \
                    (seen["declined"], pools_used)
            topo["mix"][leg] = {"host_loop_ms": host_ms, "engine_ms": ms, "served_by": served_by(moved),
                                "declined": seen["declined"], "entries": seen["entries"],
                                "nodeclaims": len(results.new_node_claims)}
    finally:
        feas.req_rows_vs_targets, feas.cube_rows = real[0], real[1]
        feas.launch, packer.launch = real[2], real[3]
        ffd._DeviceSolve.run = real[4]
    topo["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"topology": topo}))
    log(f"phase 5c took {topo['phase_s']:.1f} s")
    return topo


# the named dispatch under which each wrapper's launches are recorded, one
# dispatch a launch (the names tests/test_torch_observatory.py holds against
# the reference's); LAUNCHES names without one: uid_project (B6, no named
# dispatch in the reference either) and the scan's design counters, which
# count its launches a second time
DISPATCH_OF = {
    "row_compat": "catalog.row_compat", "cube": "feasibility.cube",
    "membership": "feasibility.membership", "solve_scan": "packer.solve_scan",
    "solve_scan_full": "packer.solve_scan_full", "solve_scan_resume": "packer.solve_scan_resume",
    "solve_block": "packer.solve_block", "delta_pass": "packer.delta_pass",
    "delta_finalize": "packer.delta_finalize",
}
UNNAMED_LAUNCHES = {"uid_project", "scan_resident", "scan_global"}
# the __global__ kernels of csrc/*.cu, as a profiler trace names them
PORT_KERNELS = ("row_compat_kernel", "membership_kernel", "cube_kernel", "cube_fused_kernel",
                "uid_project_kernel", "fits_matrix_kernel", "stage_plane_kernel",
                "group_solve_kernel", "delta_scatter_kernel", "delta_finalize_kernel",
                "solve_scan_kernel", "solve_scan_resident_kernel", "noop_kernel")

# run in a child process (a faulted context is lost for the rest of its
# process): kt_delta_finalize launched with a bogus core pointer, then a
# named dispatch returning its output, fenced under measure()
FAULT_PROBE = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from karpenter_tpu_torch.device import KernelError, launch
from karpenter_tpu_torch.ops import packer
from karpenter_tpu_torch.tracing import kernel as ktime
dev = torch.device("cuda", 0)
order = torch.zeros(1, dtype=torch.int32, device=dev)
counts = torch.ones(1, dtype=torch.int32, device=dev)
out = torch.empty((1, 4), dtype=torch.int32, device=dev)
torch.cuda.synchronize()

def faulting():
    rc = launch(dev, packer._group_lib().kt_delta_finalize, 16, order.data_ptr(),
                counts.data_ptr(), out.data_ptr(), 1, 1)
    assert rc == 0, f"the launch itself failed: cudaError {rc}"
    return (out,)

try:
    with ktime.measure():
        ktime.dispatch(faulting, kernel="chip_smoke.fault")
except KernelError as e:
    print(json.dumps({"raised": "KernelError", "message": str(e)[:300]}))
    sys.exit(0)
print(json.dumps({"raised": None}))
sys.exit(1)
"""


def fault_probe() -> dict:
    """The dispatch's fault rule on the card, in a child process: a fault
    of a kernel's device work that surfaces at the fence is a KernelError."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", FAULT_PROBE, root], capture_output=True,
                          text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    got = json.loads(lines[-1]) if lines else {}
    assert proc.returncode == 0 and got.get("raised") == "KernelError", \
        f"fault probe: exit {proc.returncode}, {proc.stdout[-2000:]} {proc.stderr[-2000:]}"
    return got


def phase_observatory(captured, device=None):
    """Phase 4c: every launch of the main path through the named dispatch,
    read back through the observatory (see the module docstring)."""
    from karpenter_tpu_torch import device as devmod
    from karpenter_tpu_torch.aot import ladder as ladder_mod
    from karpenter_tpu_torch.aot import runtime as aotrt
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.observability import efficiency
    from karpenter_tpu_torch.observability import kernels as kobs
    from karpenter_tpu_torch.ops import delta, fused, packer
    from karpenter_tpu_torch.ops.catalog import CatalogEngine
    from karpenter_tpu_torch.tracing import kernel as ktime

    t_phase = time.perf_counter()
    catalog = build_catalog()
    pods = build_pods()
    topo_pods_ = topology_pods()
    topo_env = topology_env([("default", None, [], [])])
    engines = {kind: CatalogEngine(catalog, device=device)
               for kind in ("scan", "walk", "churn", "group", "topology")}
    reqs, requests = packer_workload(engines["group"])
    solver = packer.GroupSolver(engines["group"])
    extra_req = np.tile(requests[:1], (3, 1))
    extra_req[:, engines["group"].resource_dims[wk.RESOURCE_CPU]] = 3.0  # a request no shape has
    group_inputs = [
        (reqs, requests),
        (reqs + reqs[:5000], np.vstack([requests, requests[:5000]])),
        (reqs + [reqs[0]] * 3, np.vstack([requests, extra_req])),
    ]
    churn = [build_pods()]  # pod objects of their own: a solve marks its pods
    for k in range(1, 4):
        churn.append(churn[-1] + churn_pods(k))

    def prepared(kind, k):
        """The k-th solve of a kind with its inputs made (a copy of the
        pods, a group encode), the mode set: a callable returning its wall
        ms, so that a batch scope holds the solve alone."""
        fused.FUSED_MODE = "off" if kind == "walk" else "on"
        delta.configure(mode="on" if kind in ("churn", "group") else "off", resolve_full_every=0)
        if kind in ("scan", "walk"):
            solve_pods = copy.deepcopy(pods)
            return lambda: solve(engines[kind], catalog, solve_pods)[1]
        if kind == "churn":
            return lambda: solve(engines[kind], catalog, churn[k])[1]
        if kind == "group":
            g = packer.encode_pods_for_packer(engines["group"], *group_inputs[k])

            def group_pass():
                t0 = time.perf_counter()
                solver.solve(g)
                return (time.perf_counter() - t0) * 1e3

            return group_pass
        return lambda: topology_solve(engines[kind], topo_env, catalog, topo_pods_)[1]

    reg = kobs.registry()
    builds0 = devmod.build_count()
    mode0, dmode0, every0 = fused.FUSED_MODE, delta.DELTA_MODE, delta.RESOLVE_FULL_EVERY
    plan = [("scan", 2), ("walk", 2), ("churn", 2), ("group", 2), ("topology", 2)]
    measured = [("scan", 2), ("walk", 2), ("churn", 2), ("churn", 3), ("group", 2),
                ("topology", 2)]
    batches = []
    try:
        reg.reset()
        # delta on for the churn and the group passes only; no self-check,
        # so a pass is its own launches
        delta.invalidate_all("chip-smoke")
        for kind, warm in plan:
            for k in range(warm):
                prepared(kind, k)()
        reg.seal()
        for kind, k in measured:
            label = f"{kind} {k}"
            run = prepared(kind, k)
            before = _count_launches()
            with ktime.measure() as acc, reg.batch_scope(label) as batch:
                ms = run()
            launches = {n: v - before[n] for n, v in _count_launches().items() if v != before[n]}
            batches.append((label, ms, dict(acc), batch, launches))
        compiles = devmod.build_count() - builds0
        snapshot = reg.debug_snapshot()
        counts = reg.counts_snapshot()
        steady_recompiles = reg.steady_recompiles()
    finally:
        fused.FUSED_MODE = mode0
        delta.configure(mode=dmode0, resolve_full_every=every0)
        delta.invalidate_all("chip-smoke")
    out: dict = {"batches": {}}
    for label, ms, acc, batch, launches in batches:
        unnamed = {n: v for n, v in launches.items() if n not in DISPATCH_OF}
        want = {DISPATCH_OF[n]: v for n, v in launches.items() if n in DISPATCH_OF}
        entry = {
            "wall_ms": ms, "dispatches": batch["dispatches"], "kernels": batch["kernels"],
            "launches": launches, "fenced": batch["fenced"],
            "device_busy_s": batch["device_busy_s"], "host_gap_s": batch["host_gap_s"],
            "host_stall_fraction": batch["host_stall_fraction"], "enqueue_s": acc["enqueue_s"],
            "block_s": acc["block_s"], "execute_s": acc["execute_s"],
            "timeline": [(e["kernel"], e["enqueue_s"], e["block_s"]) for e in batch["timeline"]],
        }
        out["batches"][label] = entry
        log(f"observatory {label}: {ms:.1f} ms wall, dispatches {json.dumps(batch['kernels'])}, "
            f"launches {json.dumps(launches)}, device busy {batch['device_busy_s']:.6f} s, "
            f"host stall fraction {batch['host_stall_fraction']}, block {acc['block_s']:.6f} s, "
            f"enqueue {acc['enqueue_s']:.6f} s")
        assert batch["kernels"] == want, f"{label}: dispatches {batch['kernels']}, launches {launches}"
        assert set(unnamed) <= UNNAMED_LAUNCHES, f"{label}: launches without a dispatch {unnamed}"
        assert batch["dispatches"] == batch["fenced"] == acc["dispatches"] > 0, (label, batch, acc)
        assert acc["compiles"] == 0 and all(e["block_s"] > 0 for e in batch["timeline"]), \
            f"{label}: compiles {acc['compiles']}, timeline {batch['timeline']}"
    b = out["batches"]
    assert b["scan 2"]["kernels"] == {"feasibility.cube": 1, "packer.solve_scan": 1}, b["scan 2"]
    assert b["churn 2"]["kernels"].get("packer.solve_scan_resume") == 1, b["churn 2"]
    assert b["churn 3"]["kernels"].get("packer.solve_scan_resume") == 1, b["churn 3"]
    assert b["group 2"]["kernels"] == {"packer.delta_pass": 1}, b["group 2"]
    assert compiles == 0 and steady_recompiles == 0, (compiles, steady_recompiles)
    assert all(row["compiles"] == 0 for row in snapshot["kernels"]), snapshot["kernels"]
    out["compiles"], out["steady_recompiles"] = compiles, steady_recompiles
    out["kernels"] = [{k: row[k] for k in ("kernel", "dispatches", "compiles", "recompiles",
                                           "phases", "execute_wall_s", "shapes_seen")}
                      for row in snapshot["kernels"]]
    profiled = captured.get("topo_profiled")
    if profiled:
        t = b["topology 2"]
        out["topology_vs_profiler"] = {
            "observatory_busy_share": 1.0 - t["host_stall_fraction"],
            "observatory_device_busy_s": t["device_busy_s"],
            "profiler_busy_share": profiled["busy_share"],
            "profiler_device_busy_ms": profiled["device_busy_ms"],
        }
        log(f"topology warm solve: observatory busy share {1.0 - t['host_stall_fraction']:.6f} "
            f"(fenced dispatch walls, host enqueue included) vs phase 5c's profiler "
            f"{profiled['busy_share']:.6f} (kernel time)")
    # a ladder from the observed buckets: the scan's 27-operand signature
    # parsed back into its 7 axes
    derived = ladder_mod.from_observatory(counts, headroom=0)
    out["ladder"] = {name: [list(r) for r in rungs] for name, rungs in
                     derived.to_dict()["kernels"].items()}
    assert derived.kernels.get("packer.solve_scan"), f"no scan rung derived: {out['ladder']}"
    view = aotrt.ladder_view()
    assert view["enabled"] is False and "packer.solve_scan" in view["observed"], view
    out["utilization"] = efficiency.utilization_view()  # {}: no cost tables without AOT
    # device memory against the allocator
    torch.cuda.synchronize()
    sample = kobs.sample_device_memory()
    stats = torch.cuda.memory_stats(0)
    allocated = sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))
    dev0 = sample["devices"][0]
    assert sample["live_array_bytes"] == allocated, (sample, allocated)
    assert dev0["bytes_in_use"] == stats["allocated_bytes.all.current"] and \
        dev0["peak_bytes_in_use"] == stats["allocated_bytes.all.peak"] and \
        dev0["bytes_limit"] == torch.cuda.mem_get_info(0)[1], (dev0, stats)
    out["device_memory"] = sample
    # a profiler capture around one warm solve, on the service's worker thread
    prof_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out", "profiles")
    profiler = efficiency.configure_profiler(profile_dir=prof_dir)
    assert profiler.available() and "cuda" in profiler.activities(), profiler.activities()
    solve_pods = copy.deepcopy(pods)
    fused.FUSED_MODE = "on"
    try:
        armed = profiler.arm("chip-smoke", seconds=4.0, cooldown=0)
        assert armed is not None, profiler.snapshot()
        time.sleep(0.5)
        _, prof_ms = solve(engines["scan"], catalog, solve_pods)
    finally:
        fused.FUSED_MODE = mode0
    deadline = time.perf_counter() + 120
    while profiler.snapshot()["active"]:
        assert time.perf_counter() < deadline, "the profiler capture did not stop"
        time.sleep(0.05)
    record = profiler.snapshot()["recent"][-1]
    assert "error" not in record and os.path.getsize(record["trace"]) > 0, record
    with open(record["trace"]) as f:
        events = json.load(f)["traceEvents"]
    kernel_events: dict = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = next((k for k in PORT_KERNELS if k in e.get("name", "")), "other")
            kernel_events[name] = kernel_events.get(name, 0) + 1
    out["profile"] = {"trace": os.path.relpath(record["trace"], os.path.dirname(prof_dir)),
                      "bytes": os.path.getsize(record["trace"]), "events": len(events),
                      "kernel_events": kernel_events,
                      "kt_events": sum(1 for e in events if "kt_" in e.get("name", "")),
                      "solve_ms": prof_ms, "activities": profiler.activities()}
    log(f"profiler capture: {record['trace']} ({out['profile']['bytes']} bytes, {len(events)} "
        f"events), kernel events by kernel {json.dumps(kernel_events)}, around a {prof_ms:.1f} ms "
        f"warm solve")
    out["fault"] = fault_probe()
    log(f"fault probe: {out['fault']['message']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"observatory": out}))
    return out


def dispatch_floor(reps=2000, rounds=5) -> dict:
    """The named dispatch's own floor: the empty kernel (kt_noop) launched
    through ktime.dispatch with a kernel name, without a measure() context
    (no fence: the launch stays asynchronous) and with one (every call
    fenced on an event), host us a call (median of `rounds` of `reps`) and
    the kernel's device ms."""
    from karpenter_tpu_torch.device import launch
    from karpenter_tpu_torch.observability import kernels as kobs
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.tracing import kernel as ktime

    entry = feas._lib().kt_noop
    dev = torch.device("cuda", torch.cuda.current_device())
    out = torch.empty(1, device=dev)

    def noop(_):
        assert launch(dev, entry) == 0
        return out

    def call():
        return ktime.dispatch(noop, out, kernel="chip_smoke.noop")

    for _ in range(100):
        call()
    torch.cuda.synchronize()
    host, fenced = [], []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            call()
        host.append((time.perf_counter_ns() - t0) / reps / 1e3)
        torch.cuda.synchronize()
        with ktime.measure():
            t0 = time.perf_counter_ns()
            for _ in range(reps):
                call()
            fenced.append((time.perf_counter_ns() - t0) / reps / 1e3)
    dev_ms = device_kernel_ms(call, ["noop_kernel"], reps=200)["noop_kernel"]
    row = kobs.registry().debug_snapshot("chip_smoke.noop")
    return {"device_ms": dev_ms, "dispatch_host_us": statistics.median(host),
            "measured_dispatch_host_us": statistics.median(fenced), "reps": reps,
            "rounds": rounds, "recorded": row["dispatches"]}


def solver_meshes(device=None):
    """The meshes phase_mesh drives: one device, and two shards — two
    cards when the machine has them, else the first card twice (a
    repeated device: one launch covers both shards of the sharded cube
    and group solve, the scan replicas run one after the other) — and, on
    a machine with four cards or more, four shards on four cards."""
    from karpenter_tpu_torch.mesh import Mesh

    if device == "cpu":
        d0 = d1 = torch.device("cpu")
    else:
        d0 = torch.device("cuda", 0)
        d1 = torch.device("cuda", 1) if torch.cuda.device_count() >= 2 else d0
    two = "two cards" if d1 != d0 else f"{d0} twice"
    meshes = [("1-device", Mesh([d0])), (f"2-shard ({two})", Mesh([d0, d1]))]
    if device != "cpu" and torch.cuda.device_count() >= 4:
        meshes.append(("4-shard (four cards)", Mesh([torch.device("cuda", i) for i in range(4)])))
    return meshes


def phase_mesh(captured, device=None):
    """The solver mesh on the main workload, per mesh of solver_meshes: the
    scan solve cold and warm (decisions equal to phase 4's); delta on, one
    cold pass and MESH_CHURN_PASSES churn passes, the last a self-check
    (1 miss, then warm, decisions equal to delta off, one resident state
    per shard); the group solver's sharded solve of the 200 groups against
    the unsharded solve_block. Every replica's scan outputs are compared
    with each other on the path; counts are zeroed before the first mesh
    and read after the last, and must be exact per card: the sharded cube
    and group solve launch once per card a call, the scan once per
    replica. The largest mesh's inputs are kept in `captured` for
    timing."""
    from karpenter_tpu_torch.ops import delta, fused, packer
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    catalog = build_catalog()
    pods = build_pods()
    want = captured["decisions"]
    real = (feas.sharded_cube, packer.sharded_solve_block, packer.replicate_scan)
    real_launch = feas.launch
    sweeps, blocks, replicas = [], [], []
    per_device: dict = {}  # (device, C entry point) -> launches, seen where they launch

    def launch_shim(dev, entry, *args):
        key = (str(dev), entry.__name__)
        per_device[key] = per_device.get(key, 0) + 1
        return real_launch(dev, entry, *args)

    def keep(name, value, size, latest=False):
        """The first call of the largest size (the latest with `latest`)."""
        if name not in captured or size > captured[name][0] or (latest and size == captured[name][0]):
            captured[name] = (size, value)

    def cube_factory(mesh):
        fn = real[0](mesh)

        def run(*args):
            sweeps.append(mesh.size)
            keep("sharded_cube", (mesh, args), mesh.size * 10**9 + args[0].numel())
            return fn(*args)

        return run

    def block_factory(mesh):
        fn = real[1](mesh)

        def run(*args, **kw):
            blocks.append(mesh.size)
            keep("sharded_solve_block", (mesh, args, kw), mesh.size)
            return fn(*args, **kw)

        return run

    def replicate_shim(mesh, mode, cfg, args, states=None, p_lo=0):
        if mode == "resume":
            keep("sharded_solve_scan_resume",
                 (mesh, cfg, args, [tuple(t.clone() for t in st) for st in states], p_lo), mesh.size,
                 latest=True)
        else:
            keep(f"sharded_solve_scan_{mode}", (mesh, cfg, args), mesh.size)
        outs = real[2](mesh, mode, cfg, args, states, p_lo)
        agree = all(
            all(torch.equal(_bits(a).to(b.device), _bits(b)) for a, b in zip(out, outs[0]))
            for out in outs[1:]
        )
        replicas.append((mode, len(outs), agree))
        return outs

    mode0, dmode0, every0 = fused.FUSED_MODE, delta.DELTA_MODE, delta.RESOLVE_FULL_EVERY
    feas.sharded_cube, packer.sharded_solve_block, packer.replicate_scan = (
        cube_factory, block_factory, replicate_shim)
    feas.launch = packer.launch = launch_shim
    feas.reset_launch_counts()
    packer.reset_launch_counts()
    expect = dict.fromkeys(("sharded_cube", "sharded_solve_block", "sharded_solve_scan",
                            "sharded_solve_scan_full", "sharded_solve_scan_resume"), 0)
    try:
        for label, mesh in solver_meshes(device):
            n = mesh.size
            engine = CatalogEngine(catalog, device=mesh.devices[0], mesh=mesh)
            assert fused.fused_enabled(engine), "the fused scan is not on for the mesh engine"
            before, s0, d0 = _count_launches(), len(sweeps), dict(per_device)
            delta.configure(mode="off")
            scan_ms = []
            for _ in ("cold", "warm"):
                results, ms = solve(engine, catalog, copy.deepcopy(pods))
                assert decisions(results) == want, f"{label}: the scan solve decided unlike phase 4"
                scan_ms.append(ms)
            if n == 2:
                # phase 5c's topology workload on the 2-shard mesh, cold then
                # warm: decisions equal to the unsharded solves', one
                # kt_cube_fused per card for each sweep
                tenv = topology_env([("default", None, [], [])])
                for tlabel in ("cold", "warm"):
                    sw0, pd0, tc0 = len(sweeps), dict(per_device), topo_counters()
                    tres, tms = topology_solve(engine, tenv, catalog, captured["topo_pods"])
                    tmoved, tsweeps = counters_since(tc0), len(sweeps) - sw0
                    fused_by_card = {
                        str(d): per_device.get((str(d), "kt_cube_fused"), 0)
                        - pd0.get((str(d), "kt_cube_fused"), 0)
                        for d in dict.fromkeys(mesh.devices)
                    }
                    log(f"mesh {label}: topology solve {tlabel} of {len(captured['topo_pods'])} "
                        f"pods {tms:.1f} ms, served by {served_by(tmoved)}, {tsweeps} sharded "
                        f"sweeps, kt_cube_fused per card {json.dumps(fused_by_card)}")
                    assert decisions(tres) == captured["topo_decisions"], \
                        f"{label}: the topology solve differs from the unsharded one"
                    assert served_by(tmoved) == "_TopoSolve" and not tmoved.get("device_fallbacks"), \
                        tmoved
                    assert tsweeps >= 1, f"{label}: no sharded sweep in the topology solve"
                    if mesh.devices[0].type == "cuda":
                        assert all(v == tsweeps for v in fused_by_card.values()), fused_by_card
            delta.configure(mode="on", resolve_full_every=MESH_CHURN_PASSES)
            delta.invalidate_all("chip-smoke")
            res = delta.scan_residency(engine)
            c0 = delta.delta_counters()
            cur, passes = pods, []
            for k in range(MESH_CHURN_PASSES + 1):
                if k:
                    cur = cur + churn_pods(k)
                results, ms = solve(engine, catalog, cur)
                passes.append((res.last_outcome, ms, int(res.state[0][7]), res.resident_bytes(),
                               len(res.replica_states()), results))
            single = sum(t.numel() * t.element_size() for t in res.state)
            counters = {k: v - c0.get(k, 0) for k, v in delta.delta_counters().items()
                        if v != c0.get(k, 0)}
            delta.configure(mode="off")
            off_results, off_ms = solve(engine, catalog, copy.deepcopy(cur))
            solver = packer.GroupSolver(engine)
            assert solver.mesh is mesh
            reqs, requests = packer_workload(engine)
            grouped = packer.encode_pods_for_packer(engine, reqs, requests)
            got = solver.solve(grouped)
            seen = dict(per_device)
            unsharded = uncounted(solver._solve_full, grouped)
            per_device.clear()
            per_device.update(seen)
            assert all(np.array_equal(a, b) for a, b in zip(got, unsharded)), \
                f"{label}: the sharded group solve differs from solve_block"
            moved = {k: v - before[k] for k, v in _count_launches().items() if v != before[k]}
            mesh_sweeps = len(sweeps) - s0
            checks = counters.get("delta_selfchecks_identical", 0)
            on_device = {k: v - d0.get(k, 0) for k, v in per_device.items() if v != d0.get(k, 0)}
            by_device = {str(d): {e: c for (dv, e), c in sorted(on_device.items()) if dv == str(d)}
                         for d in dict.fromkeys(mesh.devices)}
            log(f"mesh {label} {[str(d) for d in mesh.devices]}: scan solves {scan_ms[0]:.1f} "
                f"{scan_ms[1]:.1f} ms, decisions equal to phase 4; delta passes "
                f"{[(p[0], round(p[1], 1), p[2]) for p in passes]}, resident {passes[-1][3]} bytes "
                f"({passes[-1][4]} states of {single}), counters {json.dumps(counters)}, delta off "
                f"{off_ms:.1f} ms; group solve of {grouped.membership.shape[0]} groups equal to "
                f"solve_block; {mesh_sweeps} sharded sweeps; launches {json.dumps(moved)}; "
                f"kernel launches per device {json.dumps(by_device)}")
            assert [p[0] for p in passes] == ["cold"] + ["warm"] * MESH_CHURN_PASSES, \
                f"{label}: outcomes {[p[0] for p in passes]}"
            assert counters.get("delta_scan_miss", 0) == 1 and checks == 1, counters
            assert counters.get("delta_selfchecks_divergent", 0) == 0
            assert all(p[2] == CHURN_PODS for p in passes[1:]), "a resume did not run one step per new pod"
            assert all(p[4] == n and p[3] == n * single for p in passes), "not one state per shard"
            last = decisions(passes[-1][5])
            assert not last[1] and decisions(off_results) == last, f"{label}: delta != delta off"
            cards = len(set(mesh.devices))
            expect["sharded_cube"] += cards * mesh_sweeps
            expect["sharded_solve_block"] += cards
            expect["sharded_solve_scan"] += 3 * n
            expect["sharded_solve_scan_full"] += n * (1 + checks)
            expect["sharded_solve_scan_resume"] += n * MESH_CHURN_PASSES
            if mesh.devices[0].type == "cuda":
                # every launch lands on its shards' card: per shard each
                # scan replica; per card one kt_cube_fused a sweep and one
                # kt_group_solve for the block solve, whatever number of
                # shards it holds; none of the unsharded cube and block
                # kernels
                scans = 3 + 1 + checks + MESH_CHURN_PASSES
                for d in dict.fromkeys(mesh.devices):
                    k = mesh.devices.count(d)
                    want_d = {"kt_solve_scan": k * scans, "kt_cube_fused": mesh_sweeps,
                              "kt_group_solve": 1, "kt_membership": 0, "kt_cube": 0}
                    got_d = {e: by_device[str(d)].get(e, 0) for e in want_d}
                    assert got_d == want_d, f"{label}: launches on {d} {got_d}, expected {want_d}"
        launches = _count_launches()
    finally:
        feas.launch = packer.launch = real_launch
        feas.sharded_cube, packer.sharded_solve_block, packer.replicate_scan = real
        fused.FUSED_MODE = mode0
        delta.configure(mode=dmode0, resolve_full_every=every0)
    got = {k: launches[k] for k in expect}
    assert got == expect, f"mesh path launches {got}, expected {expect}"
    unsharded = {k: launches[k] for k in ("membership", "cube", "offering_reduce", "solve_block")}
    assert not any(unsharded.values()), f"unsharded cube or block launches on the mesh path: {unsharded}"
    assert launches["solve_scan"] == launches["sharded_solve_scan"]
    assert launches["solve_scan_full"] == launches["sharded_solve_scan_full"]
    assert launches["solve_scan_resume"] == launches["sharded_solve_scan_resume"]
    assert_resident(launches, "phase 5b")
    assert len(blocks) == len(solver_meshes(device)) and all(r[2] for r in replicas), \
        f"replicas disagree: {[r for r in replicas if not r[2]]}"
    log(f"mesh: {len(replicas)} replicated scans, every replica equal to shard 0's; "
        f"launches {json.dumps(got)} as expected")
    return launches


def uncounted(fn, *args):
    """fn(*args) with the launch counts put back afterwards: a check's
    launches are not its path's."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    saved = dict(feas.LAUNCHES), dict(packer.LAUNCHES)
    try:
        return fn(*args)
    finally:
        feas.LAUNCHES.update(saved[0])
        packer.LAUNCHES.update(saved[1])


def phase_group(captured, device=None):
    """The group solver on the workload's encode_pods_for_packer groups:
    solve_block and solve_block_core there against their plain versions;
    then the path, with counts zeroed just before and read just after: the
    full solve, then delta on (a self-check every warm pass) a cold pass, a
    count-only pass and a pass with new shapes, each held against the full
    solve outside the counts and timed (wall ms, ending in a copy to the
    host). The kernels' inputs kept in `captured`: the workload's groups,
    the first frontier pass's delta_pass operands, and from them B8's,
    B10's, B11's and the frontier scatter's; the count-only pass's
    delta_finalize operands."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.ops import delta, packer
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    engine = CatalogEngine(build_catalog(), device=device)
    reqs, requests = packer_workload(engine)
    captured["workload"] = (engine, reqs, requests)
    real = (packer.delta_pass, packer.delta_finalize, packer.launch)

    def pass_shim(core, slots, *args, **kw):
        captured.setdefault("delta_pass", (core.clone(), slots) + args)
        return real[0](core, slots, *args, **kw)

    def finalize_shim(core, order, counts):
        captured["delta_finalize"] = (core.clone(), order, counts)
        return real[1](core, order, counts)

    entries: dict = {}  # C entry points launched, by name

    def launch_shim(dev, entry, *a):
        entries[entry.__name__] = entries.get(entry.__name__, 0) + 1
        return real[2](dev, entry, *a)

    dmode0, every0 = delta.DELTA_MODE, delta.RESOLVE_FULL_EVERY
    delta.configure(mode="off")
    solver = packer.GroupSolver(engine)
    grouped = packer.encode_pods_for_packer(engine, reqs, requests)
    G = grouped.membership.shape[0]
    group_bools, group_ints = packer._pack_groups(grouped)
    args = (_to(group_bools, engine.device), _to(group_ints, engine.device)) + solver._catalog_args()
    captured["solve_block"] = args
    R = args[2].shape[0]
    captured["offering_reduce"] = (args[0][:, :R].contiguous(), args[3], args[4],
                                   args[0][:, R:].contiguous(), args[5], args[6], args[2].shape[1])
    check_equal(f"solve_block on the workload's {G} groups", packer.solve_block(*args),
                packer.solve_block_plain(*args))
    check_equal(f"solve_block_core on the workload's {G} groups",
                packer.solve_block_core(*args), packer.solve_block_core_plain(*args))
    log(f"group solver: solve_block and solve_block_core bit-identical to the plain versions on the "
        f"workload's groups (G={G}, R+K={group_bools.shape[1]}, I={engine.num_instances})")
    packer.delta_pass, packer.delta_finalize, packer.launch = pass_shim, finalize_shim, launch_shim
    try:
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        c0 = delta.delta_counters()
        t0 = time.perf_counter()
        full = solver._solve_full(grouped)
        full_ms = (time.perf_counter() - t0) * 1e3
        delta.configure(mode="on", resolve_full_every=1)
        delta.invalidate_all("chip-smoke")
        res = delta.group_residency(solver)
        extra = [reqs[0]] * 3
        extra_req = np.tile(requests[:1], (3, 1))
        extra_req[:, engine.resource_dims[wk.RESOURCE_CPU]] = 3.0  # a request no shape has
        trace = []
        for label, (r, q) in (
            ("cold", (reqs, requests)),
            ("count-only", (reqs + reqs[:5000], np.vstack([requests, requests[:5000]]))),
            ("new shapes", (reqs + extra, np.vstack([requests, extra_req]))),
        ):
            g = packer.encode_pods_for_packer(engine, r, q)
            s0 = delta.delta_counters()
            l0 = _count_launches()
            entries.clear()
            t0 = time.perf_counter()
            got = solver.solve(g)
            ms = (time.perf_counter() - t0) * 1e3
            s1 = delta.delta_counters()
            per = {k: v - l0[k] for k, v in _count_launches().items() if v != l0[k]}
            per_entry = dict(entries)
            want = uncounted(solver._solve_full, g)
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), f"group {label}: delta != full"
            trace.append((label, res.last_mode, g.membership.shape[0],
                          s1["delta_groups_solved"] - s0["delta_groups_solved"],
                          s1["delta_groups_reused"] - s0["delta_groups_reused"], ms, per, per_entry))
        launches = _count_launches()
        counters = {k: v - c0.get(k, 0) for k, v in delta.delta_counters().items() if v != c0.get(k, 0)}
    finally:
        packer.delta_pass, packer.delta_finalize, packer.launch = real
        delta.configure(mode=dmode0, resolve_full_every=every0)
    for label, mode, groups, solved, reused, ms, per, per_entry in trace:
        log(f"group pass {label}: {mode}, {groups} groups, {solved} solved, {reused} reused, "
            f"{ms:.2f} ms wall (a warm pass's self-check included), launches {json.dumps(per)}, "
            f"C entries {json.dumps(per_entry)}")
    log(f"group solver: full solve {int(full[1].sum())}/{G} groups feasible, "
        f"{int(full[2].sum())} nodes, {full_ms:.2f} ms wall; counters {json.dumps(counters)}; "
        f"launches {json.dumps(launches)}")
    assert [t[1] for t in trace] == ["cold", "warm", "warm"]
    assert trace[0][3] >= 1 and trace[1][3] == 0 and trace[2][3] >= 1
    checks = counters.get("delta_selfchecks_identical", 0)
    assert checks == 2 and counters.get("delta_selfchecks_divergent", 0) == 0
    # the path's own launches: the full solve and each self-check one
    # solve_block; each pass with a frontier one delta_pass (B10, B11 and
    # B12 in one kt_group_solve launch) and no delta_finalize; each pass
    # without one delta_finalize alone; nothing else of the group kernels:
    # no membership or offering_reduce beside a block solve, no
    # solve_block_core, solve_block_scatter or delta_scatter
    frontier = sum(1 for t in trace if t[3])
    want = {"solve_block": 1 + checks, "delta_pass": frontier, "delta_finalize": len(trace) - frontier,
            "solve_block_scatter": 0, "solve_block_core": 0, "delta_scatter": 0, "membership": 0,
            "offering_reduce": 0, "cube": 0}
    got = {name: launches[name] for name in want}
    assert got == want, f"group path launches {got}, expected {want}"
    for label, mode, groups, solved, reused, ms, per, per_entry in trace:
        check = per.get("solve_block", 0)  # the pass's self-check
        rule = ({"delta_pass": 1, "solve_block": check} if solved else
                {"delta_finalize": 1, "solve_block": check})
        assert {k: v for k, v in per.items() if v} == {k: v for k, v in rule.items() if v}, \
            f"group pass {label}: launches {per}"
        assert per_entry == {k: v for k, v in (("kt_group_solve", per.get("delta_pass", 0) + check),
                                               ("kt_delta_finalize", per.get("delta_finalize", 0))) if v}, \
            f"group pass {label}: C entries {per_entry}"
    # the frontier's operands on the path, and B10's and B11's from them:
    # the frontier's group rows, and the core rows they solve to scattered
    # at its slots
    core, slots, gb, gi, order, counts, *cat = captured["delta_pass"]
    captured["solve_block_scatter"] = (core, slots, gb, gi, *cat)
    captured["solve_block_core"] = (gb, gi, *cat)
    captured["delta_scatter"] = (core, slots, packer.solve_block_core_plain(gb, gi, *cat))
    return launches


def profile_warm_solve(engine, catalog, pods):
    """One more warm solve, after the launch counts were read, profiled
    (profile_run)."""
    solve_pods = copy.deepcopy(pods)
    profile_run(lambda: solve(engine, catalog, solve_pods), "profiled warm solve",
                "warm_solve_profile.txt")


def profile_run(run, label, filename) -> dict:
    """run() -> (results, wall ms) once under torch.profiler and cProfile:
    its device busy time and its host time by function (the top entries
    here, the full table in `filename` under the script's output
    directory)."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    prof = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as tprof:
        prof.enable()
        _, ms = run()
        prof.disable()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) or 0.0 for e in tprof.key_averages())
    log(f"{label}: {ms:.1f} ms wall (cProfile on), device busy "
        f"{busy_us / 1e3:.4f} ms = {busy_us / 1e3 / ms:.6f} of wall")
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if ln.lstrip().startswith("ncalls"))
    for ln in lines[start:start + 13]:
        log(f"  host {ln.strip()}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, filename), "w") as f:
        pstats.Stats(prof, stream=f).sort_stats("cumulative").print_stats(60)
    return {"wall_ms": ms, "device_busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / ms}


def phase_identity(cuda="cuda"):
    """Decisions on the 5k prefix: CUDA with the scan, CUDA with the walk,
    a device="cpu" engine (walk, plain versions); then the nodes-and-limits
    solve with the scan on CUDA and on the CPU (plain scan). Returns the
    prefix's scan operands, for timing."""
    from karpenter_tpu_torch.ops import fused
    from karpenter_tpu_torch.ops.catalog import CatalogEngine
    from karpenter_tpu_torch.scheduler import nodeclaim as ncmod

    catalog = build_catalog()
    pods = build_pods()[:PREFIX_PODS]
    out = {}
    prefix_scan = None
    for label, dev, mode in (("cuda+scan", cuda, "auto"), ("cuda+walk", cuda, "off"),
                             ("cpu", "cpu", "auto")):
        ncmod._hostname_counter = itertools.count(1)
        engine = CatalogEngine(catalog, device=dev)
        old, fused.FUSED_MODE = fused.FUSED_MODE, mode
        try:
            f0 = fused.FUSED_SOLVES
            if label == "cuda+scan":
                prefix_scan, results, ms = capture_scan(engine, catalog, pods)
            else:
                results, ms = solve(engine, catalog, copy.deepcopy(pods))
            assert (fused.FUSED_SOLVES - f0 == 1) == (label == "cuda+scan"), f"{label}: wrong path"
        finally:
            fused.FUSED_MODE = old
        out[label] = decisions(results)
        log(f"prefix {PREFIX_PODS} pods, {label}: {ms:.1f} ms, "
            f"{len(results.new_node_claims)} nodeclaims, {len(results.pod_errors)} pod errors")
    first = out["cuda+scan"]
    for label, got in out.items():
        assert got == first, f"cuda+scan and {label} decided differently"
    log(f"decision identity: {' == '.join(out)} on the {PREFIX_PODS}-pod prefix "
        f"({len(first[0])} claims)")
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types

    small = construct_instance_types()
    both = {}
    for dev in (cuda, "cpu"):
        ncmod._hostname_counter = itertools.count(1)
        _, results, ms = capture_scan(CatalogEngine(small, device=dev), small,
                                      build_pods()[:SMALL_PODS], small_case("both"))
        both[dev] = decisions(results)
        log(f"nodes+limits {SMALL_PODS} pods, scan on {dev}: {ms:.1f} ms, "
            f"{len(results.new_node_claims)} nodeclaims, {len(both[dev][2])} nodes joined, "
            f"{len(results.pod_errors)} pod errors")
    assert both[cuda] == both["cpu"], "nodes+limits: the scan on CUDA and on the CPU decided differently"
    log("decision identity: nodes+limits scan on CUDA == plain scan on the CPU")
    return prefix_scan


def device_kernel_ms(fn, names, reps=20) -> dict:
    """Per-kernel device time (ms per launch) from torch.profiler's CUDA
    activity over `reps` calls of fn: the kernel's total over the launches
    the trace holds (a trace can miss a launch of a kernel that runs
    hundreds of ms), None where it holds none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if name in ev.key:
                total += getattr(ev, "self_device_time_total", 0.0) or 0.0
                count += ev.count
        out[name] = total / 1e3 / count if total and count else None
    return out


def _max_abs_err(got, want) -> float:
    gots = got if isinstance(got, tuple) else (got,)
    wants = want if isinstance(want, tuple) else (want,)
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(gots, wants))


def _entry(name, launches, err, ms, plain_ms, bytes_moved, ops, ops_rate, library_ms, dev_ms,
           **extra):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_rate * 1e3
    return {
        "name": name,
        "route": "cuda",
        "source": SOURCE[name],
        "entry": ENTRY_POINTS[name],
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "device_ms": dev_ms,
        "bytes": bytes_moved,
        "ops": ops,
        **extra,
    }


def _dev_sum(dev_ms: dict):
    vals = [v for v in dev_ms.values() if v is not None]
    return sum(vals) if vals else None


def timing_entries(rows, cube, launches, label, phase3=None):
    """The feasibility kernels on the given inputs — `rows` a row batch as
    req_rows_vs_targets takes it, `cube` a sweep as cube_rows takes it:
    each must match its plain version there, then the wrapper, the plain
    version and the yardstick are timed with CUDA events and the kernel's
    device time is read from the profiler; B1 and B3 also get their host
    time by part (wrapper_breakdown) and ptxas's report. membership (B2,
    off the path) runs on the sweep's rows gathered; `phase3`: phase 3's
    launches of the OFF_PATH wrappers, to which its checks here add theirs
    as `check_launches` (None: no such entry is kept)."""
    from karpenter_tpu_torch.ops import feasibility as feas

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entries = []

    def words(n):
        return (n + 31) // 32

    def entry(name, kernel, plain, library, inputs, device_names, word_ops, **extra):
        l0 = _count_launches()[name]
        got, want = kernel(), plain()
        check_equal(f"{name} on {label}", got, want)
        if name in OFF_PATH and phase3 is not None:
            extra["check_launches"] = phase3[name] + _count_launches()[name] - l0
        gots = got if isinstance(got, tuple) else (got,)
        entries.append(_entry(
            name, launches, _max_abs_err(got, want), cuda_ms(kernel),
            cuda_ms(plain, reps=5, warmup=1), nbytes(*inputs) + nbytes(*gots), word_ops,
            WORD_OPS_PER_S, cuda_ms(library) if library is not None else None,
            _dev_sum(device_kernel_ms(kernel, device_names)),
            shapes=[list(t.shape) for t in inputs], **extra,
        ))

    # word ops the functions need: one AND per mask word of each (row, set)
    # pair; one AND per 32-row word of each (entity, target) pair, plus the
    # custom-key words per (entity, offering)
    table, targets, sk, vi = rows
    R, W = table.shape[0], table.shape[1] - feas.ROW_FIELDS
    K = targets[0][0].shape[1]
    N = sum(t[0].shape[0] for t in targets)
    run_rows = lambda: feas.req_rows_vs_targets(*rows)  # noqa: E731
    packs = [feas.pack_sets(*t) for t in targets]
    key_slots = feas.key_slot_words(sk, K)
    set_inputs = [a for t in targets for a in t]
    entry("row_compat", run_rows,
          lambda: feas.req_rows_vs_targets_plain(table, packs, key_slots, vi), None,
          [table] + set_inputs + [sk, vi], ["row_compat_kernel"], R * N * W,
          targets=[t[0].shape[0] for t in targets], breakdown=wrapper_breakdown(run_rows),
          ptxas={k: v for k, v in FEAS_PTXAS.items() if "row_compat_kernel" in k},
          plain_from="req_rows_vs_sets_plain per target on the packs unpacked")

    mem, kp, idx, rc, oc, cn, av, ow = cube
    Ru = idx.shape[0]
    # the rows the sweep reads: its used rows only, by index
    rc_u, oc_u = rc.index_select(0, idx.long()), oc.index_select(0, idx.long())
    mem_u = mem[:, :Ru].contiguous()
    P, I, (O, Kc) = mem.shape[0], rc.shape[1], cn.shape
    entry("membership", lambda: feas.membership_all(mem_u, rc_u),
          lambda: feas.membership_all_plain(mem_u, rc_u),
          lambda: (mem_u.float() @ (~rc_u).float()) < 0.5,
          (mem_u, rc_u), ["membership_kernel"], P * I * words(Ru))
    run_cube = lambda: feas.cube_rows(*cube)  # noqa: E731
    entry("cube", run_cube, lambda: feas.cube_rows_plain(*cube),
          lambda: cube_f32(mem_u, rc.index_select(0, idx.long()), oc.index_select(0, idx.long()),
                           cn, kp, av, ow),
          (mem_u, kp, idx, rc_u, oc_u, cn, av, ow), ["cube_kernel"],
          P * I * words(Ru) + P * O * (words(Ru) + words(Kc)),
          library_call="the reference's f32 4-matmul form after index_select of the used rows",
          bytes_note="the used rows only, read by index (the gather's padding rows are not read)",
          resident_rows=int(rc.shape[0]), breakdown=wrapper_breakdown(run_cube),
          ptxas={k: v for k, v in FEAS_PTXAS.items() if "cube_kernel" in k})
    return entries


def scan_entries(uid_args, scan, prefix_scan, launches, plain):
    """uid_project (its factored form) on the main path's famu_ok inputs
    (yardstick: the reference's f32 matmul form on the product mask, built
    outside the timing), with its host time by part and ptxas's report;
    solve_scan on the main path's operands
    (the wrapper's ms, the kernel's device ms, steps and us per step, the
    bound), checked and set against its plain version on the same operands
    (one run of the plain loop, ~40 s at 50k pods), and timed on the 5k
    prefix's operands too."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    onehot, tmpl, fam = uid_args
    run = lambda: feas.uid_project_factored(onehot, tmpl, fam)  # noqa: E731
    got, want = run(), feas.uid_project_factored_plain(onehot, tmpl, fam)
    check_equal("uid_project_factored on the main path's inputs", got, want)
    U, I = onehot.shape
    R = tmpl.shape[0] * fam.shape[0]
    prod = (tmpl[:, None, :] & fam[None, :, :]).reshape(R, I).float()
    # word ops the function needs: one AND of the two masks and one OR per
    # 32-type word of each (row, uid) pair, the count the feasibility
    # entries use
    uid = _entry(
        "uid_project", launches, _max_abs_err(got, want), cuda_ms(run),
        cuda_ms(lambda: feas.uid_project_factored_plain(onehot, tmpl, fam), reps=5, warmup=1),
        nbytes(onehot, tmpl, fam, got), R * U * ((I + 31) // 32) + R * ((I + 31) // 32),
        WORD_OPS_PER_S, cuda_ms(lambda: (prod @ onehot.float().T) > 0.5),
        _dev_sum(device_kernel_ms(run, ["uid_project_kernel"])),
        shapes=[list(onehot.shape), list(tmpl.shape), list(fam.shape)],
        library_call="f32 matmul of the product mask (built outside the timing) > 0.5",
        breakdown=wrapper_breakdown(run), bare_launch_ms=bare_launch_ms(run),
        ptxas={k: v for k, v in FEAS_PTXAS.items() if "uid_project_kernel" in k},
    )

    cfg, args = scan
    assert packer.scan_design(cfg, args) == "resident", "the main path's scan does not fit the resident set"
    check_resident_bytes(cfg, args)
    run = lambda: packer.solve_scan(cfg, args)  # noqa: E731
    out = run()
    out_global = packer.solve_scan(cfg, args, _design="global")
    torch.cuda.synchronize()
    n_pods = int(args[13])
    placed = int((out[4][:n_pods] >= 0).sum())
    assert placed == n_pods, f"solve_scan: {n_pods - placed} pods unplaced on the main path"
    steps = int(out[packer.SCAN_N_OUT])  # the kernel's own count of loop iterations
    assert steps >= n_pods, f"solve_scan: {steps} steps for {n_pods} placed pods"
    ms = cuda_ms(run, reps=1, warmup=1, rounds=3)
    global_ms = cuda_ms(lambda: packer.solve_scan(cfg, args, _design="global"), reps=1, warmup=1, rounds=3)
    prof_ms = _dev_sum(device_kernel_ms(run, SCAN_KERNELS, reps=2))
    G, D = args[2].shape
    U = args[4].shape[0]
    # float64 compares and subtractions per step: the refreshed cfit row
    # (G groups x U rows x D dims), the join's fit test and the committed
    # row (U x D each)
    f64_ops = steps * (G * U * D + 2 * U * D)
    want, plain_ms = cuda_ms_once(lambda: packer.solve_scan_plain(cfg, args))
    check_equal("solve_scan on the main path's operands (resident)", tuple(out), tuple(want))
    check_equal("solve_scan on the main path's operands (global)", tuple(out_global), tuple(want))
    plain["solve_scan"] = (args, want, plain_ms)
    # the two designs' device time in turns on one card, then the resident
    # design at each block size, each held against the plain loop first
    turns = []
    for design in ("resident", "global", "global", "resident"):
        t = scan_launch_ms(cfg, args, design=design)
        turns.append({"design": design, "device_ms": t, "us_per_step": t * 1e3 / steps})
    blocks = []
    for threads in SCAN_BLOCK_SIZES:
        state = packer._alloc_state(cfg, args)
        packer._launch_scan(cfg, args, state, packer._MODE_FULL, design="resident", threads=threads)
        check_equal(f"solve_scan resident at {threads} threads", packer._scan_finals(state) + (state[0][7],),
                    tuple(want))
        t = scan_launch_ms(cfg, args, design="resident", threads=threads)
        blocks.append({"threads": threads, "device_ms": t, "us_per_step": t * 1e3 / steps})
    dev_ms = statistics.mean(t["device_ms"] for t in turns if t["design"] == "resident")
    global_dev_ms = statistics.mean(t["device_ms"] for t in turns if t["design"] == "global")
    log(f"solve_scan designs in turns: {json.dumps(turns)}; resident by block size {json.dumps(blocks)} "
        f"(default {packer.SCAN_THREADS})")
    pcfg, pargs = prefix_scan
    scan = _entry(
        "solve_scan", launches, _max_abs_err(tuple(out), tuple(want)), ms, plain_ms,
        nbytes(*args) + nbytes(*out), f64_ops, F64_OPS_PER_S, None, dev_ms,
        steps=steps, us_per_step=dev_ms * 1e3 / steps, device_ms_profiler=prof_ms,
        device_ms_by="CUDA events around the bare launch, mean of the two resident turns",
        design="resident", threads=packer.SCAN_THREADS,
        launches_by_design={k: launches[k] for k in ("scan_resident", "scan_global")},
        resident_bytes=packer.scan_resident_bytes(packer._scan_dims(cfg, args)),
        global_ms=global_ms, global_device_ms=global_dev_ms, global_us_per_step=global_dev_ms * 1e3 / steps,
        max_abs_err_global=_max_abs_err(tuple(out_global), tuple(want)),
        design_turns=turns, block_sizes=blocks, ptxas=PTXAS,
        prefix_ms=cuda_ms(lambda: packer.solve_scan(pcfg, pargs), reps=1, warmup=1, rounds=3),
        prefix_pods=int(pargs[13]),
        shapes={"P": int(args[0].shape[0]), "G": G, "C": int(args[1].shape[0]), "U": U, "D": D,
                "F": int(args[10].shape[0]), "T": cfg[0], "nodes": cfg[1], "limits": cfg[2]},
    )
    return [uid, scan]


def cuda_ms_once(fn):
    """(fn(), its milliseconds): CUDA events around one call."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def scan_launch_ms(cfg, args, rounds=3, design=None, threads=None) -> float:
    """Device ms of one bare kt_solve_scan launch in full mode on `args`
    (state allocated beforehand, no operand checks) in `design` (None: the
    wrapper's choice) at `threads` (the resident design's block size; None:
    the wrapper's): CUDA events bracketing the launch alone, median over
    `rounds` after one warmup. The profiler's trace can hold none of a
    launch this long, so the scans' device time is read this way."""
    from karpenter_tpu_torch.ops import packer

    state = packer._alloc_state(cfg, args)
    threads = threads or packer.SCAN_THREADS
    return cuda_ms(lambda: packer._launch_scan(cfg, args, state, packer._MODE_FULL, design=design,
                                               threads=threads),
                   reps=1, warmup=1, rounds=rounds)


def replicated_launch_ms(mesh, cfg, args, rounds=3):
    """Device ms of one replicated scan call's bare kt_solve_scan launches
    in full mode (every shard's operands copied and its state allocated
    beforehand, no operand checks): a start event on every distinct
    device's current stream, then each shard's launch, then an end event on
    every device. Per device the span from its start to its end, median
    over `rounds` after one warmup; returns (the largest span, the span per
    device). On one card the replicas run one after the other inside its
    span; on distinct cards they overlap."""
    from karpenter_tpu_torch import mesh as mesh_mod
    from karpenter_tpu_torch.ops import packer

    rep = [mesh_mod.per_shard(a, mesh) for a in args]
    shards = [tuple(r[s] for r in rep) for s in range(mesh.size)]
    states = [packer._alloc_state(cfg, a) for a in shards]
    devs = list(dict.fromkeys(mesh.devices))
    spans: dict = {str(d): [] for d in devs}
    for k in range(rounds + 1):
        for d in devs:
            torch.cuda.synchronize(d)
        events = {}
        for d in devs:
            with torch.cuda.device(d):
                events[d] = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                events[d][0].record()
        for a, st in zip(shards, states):
            packer._launch_scan(cfg, a, st, packer._MODE_FULL)
        for d in devs:
            with torch.cuda.device(d):
                events[d][1].record()
        for d in devs:
            events[d][1].synchronize()
            if k:
                spans[str(d)].append(events[d][0].elapsed_time(events[d][1]))
    per_device = {d: statistics.median(v) for d, v in spans.items()}
    return max(per_device.values()), per_device


def plain_scans(captured, plain):
    """The plain loop on phase 4's scan operands, once: its full state for
    solve_scan_full and its decode subset for solve_scan (what
    solve_scan_plain returns), for mesh_entries when phase 7's scan entries
    do not run (--mesh)."""
    from karpenter_tpu_torch.ops import packer

    cfg, args = captured["solve_scan"]
    want, ms = cuda_ms_once(lambda: packer.solve_scan_full_plain(cfg, args))
    plain["solve_scan_full"] = (args, want, ms)
    plain["solve_scan"] = (args, packer._scan_finals(want[:-1]) + (want[-1],), ms)


def resume_bytes(cfg, args, before, after, p_lo) -> int:
    """The bytes a resume of the suffix [p_lo, n_pods) has to move, from
    the state before and after it, each counted once: the scalars read and
    written; per suffix pod its group id and last_len read, its queue entry
    and pod_claim/pod_node/pod_seq written; the claim pick's reads (cfit's
    column of each suffix group over the claims then open, the candidate
    claims' keys); the rows of the claims it touched (rem, u_valid and the
    three ints read and written, the key and the cfit row written); and the
    cfit refresh's operands for those claims (the famu_ok rows, transition
    rows and tolerations of each distinct (template, family), g_floor). For
    the variant without nodes or limits, the one the delta phase drives."""
    from karpenter_tpu_torch.ops import packer

    assert not cfg[1] and not cfg[2], f"resume_bytes counts the plain variant, not {cfg}"
    (pod_gi, _, _, g_floor, _, _, tol, _, _, _, trans_kind, trans_fam, famu_ok) = args[:13]
    n_pods = int(args[13])
    s0 = dict(zip(packer.SCAN_STATE_FIELDS, before))
    s1 = dict(zip(packer.SCAN_STATE_FIELDS, after))
    nsuf = max(n_pods - int(p_lo), 0)
    groups = torch.unique(pod_gi[int(p_lo):n_pods].long())
    nclaims0 = int(s0["scal"][6])
    cand = s0["cfit"][:nclaims0][:, groups].any(dim=1)
    touched = torch.nonzero(s1["claim_count"] != s0["claim_count"]).flatten()
    pairs = {(int(s1["claim_ti"][c]), int(s1["claim_fam"][c])) for c in touched.tolist()}
    row = lambda t: t[0].numel() * t.element_size()  # noqa: E731
    per_claim = (2 * (row(s0["rem"]) + row(s0["u_valid"]) + 3 * 4) + 8 + row(s0["cfit"]))
    G, U = g_floor.shape[0], famu_ok.shape[2]
    per_pair = G * U * famu_ok.element_size() + row(trans_kind) + row(trans_fam) + row(tol)
    return (2 * nbytes(s0["scal"]) + nsuf * (4 + 4 + 4 + 3 * 4)
            + len(groups) * nclaims0 * s0["cfit"].element_size()
            + int(cand.sum()) * s0["claim_key"].element_size()
            + len(touched) * per_claim + len(pairs) * per_pair + nbytes(g_floor))


def cuda_ms_fresh(make, run, rounds=5) -> float:
    """Milliseconds per call of run(make()) for a function that writes its
    inputs in place: CUDA events around each call alone, on inputs made
    fresh before it, median over `rounds` after one warmup."""
    run(make())
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        inp = make()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run(inp)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def scan_state_entries(scan, resume, launches, plain):
    """solve_scan_full (B15) on the main path's operands, checked against
    its plain version on the same operands (all 17 state tensors, float64
    as raw bits; one run of the plain loop); and solve_scan_resume (B16) on
    the last churn pass's inputs (the resident state before it, the 27
    operands, p_lo), checked against the plain resume on the same inputs."""
    from karpenter_tpu_torch.ops import packer

    cfg, args = scan
    G, D = args[2].shape
    U = args[4].shape[0]
    run = lambda: packer.solve_scan_full(cfg, args)  # noqa: E731
    out = run()
    out_global = packer.solve_scan_full(cfg, args, _design="global")
    steps = int(out[-1])
    ms = cuda_ms(run, reps=1, warmup=1, rounds=3)
    prof_ms = _dev_sum(device_kernel_ms(run, SCAN_KERNELS, reps=2))
    dev_ms = scan_launch_ms(cfg, args)
    want, plain_ms = cuda_ms_once(lambda: packer.solve_scan_full_plain(cfg, args))
    check_equal("solve_scan_full on the main path's operands (resident)", tuple(out), tuple(want))
    check_equal("solve_scan_full on the main path's operands (global)", tuple(out_global), tuple(want))
    plain["solve_scan_full"] = (args, want, plain_ms)
    full = _entry(
        "solve_scan_full", launches, _max_abs_err(tuple(out), tuple(want)), ms, plain_ms,
        nbytes(*args) + nbytes(*out), steps * (G * U * D + 2 * U * D), F64_OPS_PER_S, None, dev_ms,
        steps=steps, us_per_step=dev_ms * 1e3 / steps, device_ms_profiler=prof_ms,
        device_ms_by="CUDA events around the bare launch", design="resident",
        max_abs_err_global=_max_abs_err(tuple(out_global), tuple(want)),
    )
    rcfg, rargs, state0, p_lo = resume
    fresh = lambda: tuple(t.clone() for t in state0)  # noqa: E731
    got = packer.solve_scan_resume(rcfg, rargs, fresh(), p_lo)
    got_global = packer.solve_scan_resume(rcfg, rargs, fresh(), p_lo, _design="global")
    want = packer.solve_scan_resume_plain(rcfg, rargs, fresh(), p_lo)
    check_equal("solve_scan_resume on the last churn pass's inputs (resident)", tuple(got), tuple(want))
    check_equal("solve_scan_resume on the last churn pass's inputs (global)", tuple(got_global), tuple(want))
    rsteps = int(got[-1])
    rms = cuda_ms_fresh(fresh, lambda st: packer.solve_scan_resume(rcfg, rargs, st, p_lo))
    rms_global = cuda_ms_fresh(fresh, lambda st: packer.solve_scan_resume(rcfg, rargs, st, p_lo, _design="global"))
    rdev = device_kernel_ms(lambda: packer.solve_scan_resume(rcfg, rargs, fresh(), p_lo),
                            SCAN_KERNELS, reps=5)
    rdev_ms = _dev_sum(rdev)
    rdev_global = _dev_sum(device_kernel_ms(
        lambda: packer.solve_scan_resume(rcfg, rargs, fresh(), p_lo, _design="global"), SCAN_KERNELS, reps=5))
    log(f"delta: the resume kernel's device time {rdev_ms} ms for the last churn pass's "
        f"{rsteps} steps (wrapper {rms:.4f} ms, CUDA events); global design {rdev_global} ms "
        f"(wrapper {rms_global:.4f} ms)")
    RG, RD = rargs[2].shape
    RU = rargs[4].shape[0]
    resume_entry = _entry(
        "solve_scan_resume", launches, _max_abs_err(tuple(got), tuple(want)), rms,
        cuda_ms_fresh(fresh, lambda st: packer.solve_scan_resume_plain(rcfg, rargs, st, p_lo), rounds=1),
        resume_bytes(rcfg, rargs, state0, got[:-1], p_lo), rsteps * (RG * RU * RD + 2 * RU * RD),
        F64_OPS_PER_S, None, rdev_ms, steps=rsteps,
        us_per_step=(rdev_ms * 1e3 / rsteps) if rdev_ms and rsteps else None, p_lo=int(p_lo),
        design="resident", global_ms=rms_global, global_device_ms=rdev_global,
    )
    return [full, resume_entry]


GROUP_SPLIT_PARTS = ("pack", "offerings", "types", "reduce")


def group_phase_split(args, mode, reps=50, warmup=5) -> dict:
    """Where one kt_group_solve launch spends its device time: `reps`
    launches (after `warmup`) with the kernel's timestamp buffer,
    uncounted. Per launch block 0's microseconds by phase (%globaltimer:
    the pack of the group's words, the first window of usable offerings,
    the type pass, the reduction) and its SM cycles by phase (clock64); the
    launch's span from the first block's start to the last block's end, the
    latest block start, every block's duration (median, 90th percentile,
    longest), the SMs the blocks ran on and the most blocks on one SM, and
    the mean duration of blocks that shared their SM and of those alone on
    it. Medians over the launches."""
    from karpenter_tpu_torch.ops import packer

    dev = args[0].device
    G = args[0].shape[0]
    name = "solve_block" if mode == "finalize" else "solve_block_core"
    H = packer.GROUP_STAMPS
    stamps = torch.zeros((warmup + reps, H + 3 * G), dtype=torch.int64, device=dev)
    stamps[:, 10] = -1  # the least start, folded with an unsigned atomicMin
    for k in range(warmup + reps):
        uncounted(lambda s=stamps[k]: packer._group_solve(name, mode, args[0], args[1], args[2:],
                                                          stamps=s))
    torch.cuda.synchronize()
    st = stamps.cpu().numpy()[warmup:].astype(np.float64)
    ns, cyc = st[:, 0:5], st[:, 5:10]
    out = {f"{part}_us": float(np.median(ns[:, k + 1] - ns[:, k])) / 1e3
           for k, part in enumerate(GROUP_SPLIT_PARTS)}
    out.update({f"{part}_cycles": float(np.median(cyc[:, k + 1] - cyc[:, k]))
                for k, part in enumerate(GROUP_SPLIT_PARTS)})
    out["block0_us"] = float(np.median(ns[:, 4] - ns[:, 0])) / 1e3
    out["span_us"] = float(np.median(st[:, 11] - st[:, 10])) / 1e3
    out["latest_start_us"] = float(np.median(st[:, 12] - st[:, 10])) / 1e3
    blocks = st[:, H:].reshape(reps, G, 3)
    dur = (blocks[:, :, 1] - blocks[:, :, 0]) / 1e3
    out["block_us"] = {"median": float(np.median(np.median(dur, axis=1))),
                       "p90": float(np.median(np.percentile(dur, 90, axis=1))),
                       "longest": float(np.median(dur.max(axis=1)))}
    shared, alone, per_sm = [], [], []
    for k in range(reps):
        sms, counts = np.unique(blocks[k, :, 2], return_counts=True)
        per_sm.append((len(sms), int(counts.max())))
        n_on = dict(zip(sms, counts))
        on = np.array([n_on[v] for v in blocks[k, :, 2]])
        shared += list(dur[k][on > 1])
        alone += list(dur[k][on == 1])
    out["sms"] = int(np.median([p[0] for p in per_sm]))
    out["most_blocks_on_an_sm"] = int(np.median([p[1] for p in per_sm]))
    out["shared_sm_block_us"] = float(np.mean(shared)) if shared else None
    out["alone_sm_block_us"] = float(np.mean(alone)) if alone else None
    out["launches"] = reps
    return out


def group_entries(captured, launches, phase3):
    """offering_reduce on the workload's groups' planes; solve_block on the
    workload's groups and solve_block_core on the first frontier's rows
    (device-resident operands); solve_block_scatter on that frontier as the
    residency gave it; delta_scatter on its slots and core rows;
    delta_finalize on the inputs the residency gave it: each matched
    against its plain version, then timed. B9, B10 and the scatter mode
    also get their host time by part (wrapper_breakdown), kt_group_solve's
    phase split (group_phase_split) and ptxas's report; B11 its turns
    against index_put_. Bytes: each input read once and each output
    written once (for the scatters the rows they write, for
    delta_finalize the core rows it gathers too). `launches`: the group
    path's counts; `phase3`: phase 3's launches of the OFF_PATH wrappers,
    to which these checks add theirs as `check_launches`."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    entries = []
    counts = dict(launches)

    def words(n):
        return (n + 31) // 32

    def add(name, kernel, plain, library, inputs, device_names, ops, out_bytes=None, **extra):
        l0 = _count_launches()[name]
        got, want = kernel(), plain()
        check_equal(f"{name} on the group path's inputs", got, want)
        if name in OFF_PATH:
            extra["check_launches"] = phase3[name] + _count_launches()[name] - l0
        entries.append(_entry(
            name, counts, _max_abs_err(got, want), cuda_ms(kernel),
            cuda_ms(plain, reps=5, warmup=1),
            nbytes(*inputs) + (nbytes(got) if out_bytes is None else out_bytes), ops, WORD_OPS_PER_S,
            cuda_ms(library) if library is not None else None,
            _dev_sum(device_kernel_ms(kernel, device_names)),
            shapes=[list(t.shape) for t in inputs], **extra,
        ))

    off = captured["offering_reduce"]
    P, R = off[0].shape
    O, K = off[2].shape

    def offering_f32():
        """The reference's f32 form (three matmuls), the yardstick."""
        m, oc, cn, kp, av, ow, n = off
        rows_ok = (m.float() @ (~oc).float()) < 0.5
        undef_ok = ((cn.float() @ (~kp).float().T) < 0.5).T
        onehot = torch.zeros((O, n), device=m.device)
        onehot[torch.arange(O, device=m.device), ow.long()] = 1.0
        return ((rows_ok & undef_ok & av[None, :]).float() @ onehot) > 0.5

    add("offering_reduce", lambda: feas.offering_reduce(*off), lambda: feas.offering_reduce_plain(*off),
        offering_f32, off[:6], ["cube_kernel"], P * O * (words(R) + words(K)),
        library_call="the reference's f32 matmul form")

    def solve_ops(args):
        G = args[0].shape[0]
        Rr, Ii = args[2].shape
        Oo, Kk = args[4].shape
        Dd = args[7].shape[1]
        return G * Ii * words(Rr) + G * Oo * (words(Rr) + words(Kk)) + G * Ii * (Dd + 1)

    def yardstick(args):
        """One argmin over the masked price, on feasibility computed
        beforehand (no single call computes the whole solve)."""
        Rr, Ii = args[2].shape
        Dd = args[7].shape[1]
        mem, kp = args[0][:, :Rr], args[0][:, Rr:]
        feasible = (
            feas.membership_all_plain(mem, args[2])
            & feas.offering_reduce_plain(mem, args[3], args[4], kp, args[5], args[6], Ii)
            & (args[1][:, None, :Dd] <= args[7][None, :, :]).all(dim=-1)
        )
        inf = torch.tensor(3.4e38, dtype=torch.float32, device=args[8].device)
        return lambda f=feasible, pr=args[8]: torch.argmin(torch.where(f, pr[None, :], inf), dim=1)

    ptxas = GROUP_PTXAS
    for name, mode in (("solve_block", "finalize"), ("solve_block_core", "core")):
        args = captured[name]
        run = lambda k=getattr(packer, name), a=args: k(*a)  # noqa: E731
        add(name, run, lambda p=getattr(packer, f"{name}_plain"), a=args: p(*a), yardstick(args), args,
            ["group_solve_kernel"], solve_ops(args),
            library_call="torch.argmin over the masked price (feasibility precomputed)",
            breakdown=wrapper_breakdown(run), phase_split=group_phase_split(args, mode),
            bare_launch_ms=bare_launch_ms(run), ptxas=ptxas)

    core, slots, *sargs = captured["solve_block_scatter"]
    c_k, c_p = core.clone(), core.clone()
    run = lambda: packer.solve_block_scatter(c_k, slots, *sargs)  # noqa: E731
    add("solve_block_scatter", run, lambda: packer.solve_block_scatter_plain(c_p, slots, *sargs), None,
        [slots] + list(sargs), ["group_solve_kernel"], solve_ops(sargs), out_bytes=slots.shape[0] * 12,
        breakdown=wrapper_breakdown(run), bare_launch_ms=bare_launch_ms(run), cap=int(core.shape[0]),
        replaces_composition="solve_block_core then delta_scatter_rows (B10 + B11)")

    # the pass with a frontier as the path ran it: one launch; rewriting
    # the same rows is idempotent, so repeated calls time it
    core, slots, gb, gi, order, counts_, *cat = captured["delta_pass"]
    c_k, c_p = core.clone(), core.clone()
    counter = torch.zeros(1, dtype=torch.int32, device=core.device)
    run = lambda: packer.delta_pass(c_k, slots, gb, gi, order, counts_, *cat, counter=counter)  # noqa: E731
    Gb = order.shape[0]
    add("delta_pass", run, lambda: packer.delta_pass_plain(c_p, slots, gb, gi, order, counts_, *cat), None,
        [slots, gb, gi, order, counts_] + list(cat), ["group_solve_kernel", "Memset"],
        solve_ops((gb, gi, *cat)) + Gb * 8, out_bytes=slots.shape[0] * 12 + Gb * 12 + Gb * 16,
        breakdown=wrapper_breakdown(run), bare_launch_ms=bare_launch_ms(run), cap=int(core.shape[0]),
        frontier=int(gb.shape[0]), groups=int(Gb),
        bytes_note="the frontier's inputs and core rows written, the pass's core rows gathered and "
                   "its finalized rows written",
        replaces_composition="solve_block_scatter then delta_finalize (B10 + B11, then B12): 2 launches",
        pass_timings=delta_group_pass_timings(captured["workload"]))
    check_equal("delta_pass's core on the group path's inputs", c_k, c_p)

    # rewriting the same rows is idempotent, so repeated calls time it
    core, slots, rows = captured["delta_scatter"]
    c_k, c_p, c_l = core.clone(), core.clone(), core.clone()
    scatter = lambda: packer.delta_scatter_rows(c_k, slots, rows)  # noqa: E731
    slots_l = slots.long()  # index_put_ takes int64 indices: converted once, outside the timing
    index_put = lambda: c_l.index_put_((slots_l,), rows)  # noqa: E731
    # the kernel against index_put_ in turns, each the median of 41 rounds
    turns = [{"which": w, "ms": cuda_ms(f, rounds=41)}
             for w, f in (("kernel", scatter), ("index_put_", index_put), ("index_put_", index_put),
                          ("kernel", scatter))]
    add("delta_scatter", scatter, lambda: packer.delta_scatter_rows_plain(c_p, slots, rows),
        index_put, (slots, rows), ["delta_scatter_kernel"], 0,
        out_bytes=nbytes(rows), library_call="index_put_ (core[slots] = rows)", cap=int(core.shape[0]),
        turns=turns, breakdown=wrapper_breakdown(scatter), bare_launch_ms=bare_launch_ms(scatter))

    fcore, order, counts_ = captured["delta_finalize"]
    Gb = order.shape[0]
    add("delta_finalize", lambda: packer.delta_finalize(fcore, order, counts_),
        lambda: packer.delta_finalize_plain(fcore, order, counts_), None, (order, counts_),
        ["delta_finalize_kernel"], Gb * 8, out_bytes=Gb * 4 * 4 + Gb * 3 * 4, cap=int(fcore.shape[0]))
    return entries


def fits_stage_entries(captured, launches):
    """fits_matrix on the workload's quantized requests against its 1008
    allocatables (int32, the exact path's units; float32 beside it) and
    stage_plane on the planes of its 200 shapes' sweep (phase 5's group
    engine): checked, then timed. `launches`: the main path's counts (0:
    no path of the reference runs them); phase 3's and these checks'
    launches go in `check_launches`."""
    from karpenter_tpu_torch.ops import feasibility as feas

    engine, reqs, requests = captured["workload"]
    dev = engine.device
    n0 = {k: feas.LAUNCHES[k] for k in ("fits_matrix", "stage_plane")}
    scales = feas.resource_scales(engine.resource_dims)
    req_q = feas.quantize_resources(requests, ceil=True, scales=scales).astype(np.int32)
    alloc_q = feas.quantize_resources(engine.allocatable, ceil=False, scales=scales).astype(np.int32)
    inputs, checked = {}, {}
    for dtype in (np.int32, np.float32):
        dt = np.dtype(dtype).name
        r, a = inputs[dt] = _to(req_q.astype(dtype), dev), _to(alloc_q.astype(dtype), dev)
        checked[dt] = feas.fits_matrix(r, a), feas.fits_matrix_plain(r, a)
        check_equal(f"fits_matrix {dt} on the workload's {len(req_q)} pods", *checked[dt])
    distinct: dict = {}
    for r, q in zip(reqs, requests):
        distinct.setdefault(id(r), (r, q))
    shape_reqs = [r for r, _ in distinct.values()]
    f = engine.feasibility([engine.rows_for(r) for r in shape_reqs],
                           np.stack([q for _, q in distinct.values()]), engine.key_presence(shape_reqs))
    planes = tuple(_to(np.ascontiguousarray(a), dev) for a in (f.compat, f.fits, f.has_offering))
    got_plane, want_plane = feas.stage_plane(*planes), feas.stage_plane_plain(*planes)
    check_equal(f"stage_plane on the sweep of the workload's {len(shape_reqs)} shapes", got_plane, want_plane)
    assert np.array_equal(got_plane.cpu().numpy(), feas.stage_plane_np(f.compat, f.fits, f.has_offering))
    checks = {k: captured["phase3_launches"][k] + feas.LAUNCHES[k] - n0[k] for k in n0}
    log(f"fits_matrix and stage_plane bit-identical to the plain versions on the workload's "
        f"{len(req_q)} x {len(alloc_q)} fits (int32, float32) and its {len(shape_reqs)} shapes' "
        f"stage plane {json.dumps(feas.stage_counts(got_plane.cpu().numpy()))}; launches with "
        f"phase 3's {json.dumps(checks)}")
    entries = []
    timed = {}
    for dt in ("int32", "float32"):
        r, a = inputs[dt]
        got, want = checked[dt]
        (P, D), I = r.shape, a.shape[0]
        rate = WORD_OPS_PER_S if dt == "int32" else F32_OPS_PER_S
        timed[dt] = (
            _max_abs_err(got, want), cuda_ms(lambda: feas.fits_matrix(r, a)),
            cuda_ms(lambda: feas.fits_matrix_plain(r, a), reps=5, warmup=1),
            nbytes(r, a, got), P * I * D, rate,
            _dev_sum(device_kernel_ms(lambda: feas.fits_matrix(r, a), ["fits_matrix_kernel"])),
            [list(r.shape), list(a.shape)],
        )
    err, ms, pms, nb, ops, rate, dev_ms, shapes = timed["int32"]
    f32 = timed["float32"]
    entries.append(_entry(
        "fits_matrix", launches, err, ms, pms, nb, ops, rate, None, dev_ms, shapes=shapes,
        check_launches=checks["fits_matrix"], dtype="int32", ms_float32=f32[1], plain_ms_float32=f32[2], device_ms_float32=f32[6],
        bound_ms_float32=max(f32[3] / HBM_BYTES_PER_S, f32[4] / f32[5]) * 1e3,
        max_abs_err_float32=f32[0],
    ))
    got, want = got_plane, want_plane
    # up to three tests and a select per element
    entries.append(_entry(
        "stage_plane", launches, _max_abs_err(got, want), cuda_ms(lambda: feas.stage_plane(*planes)),
        cuda_ms(lambda: feas.stage_plane_plain(*planes), reps=5, warmup=1), nbytes(*planes, got),
        4 * got.numel(), WORD_OPS_PER_S, None,
        _dev_sum(device_kernel_ms(lambda: feas.stage_plane(*planes), ["stage_plane_kernel"])),
        shapes=[list(planes[0].shape)] * 3, check_launches=checks["stage_plane"],
    ))
    return entries


def _sharded_entry(name, mesh, launches, got, want, ms, plain_ms, shard_bytes, shard_ops, rate,
                   library_ms, dev_ms, card_bytes=0, **extra):
    """An entry of a sharded twin: the bound is that of the busiest card
    (the shards it holds, each shard's bytes and operations, plus
    `card_bytes` read once per card: the replicated catalog of a wrapper
    that launches once per card), with the bound of one shard and of all
    shards' work beside it."""
    k = max(mesh.devices.count(d) for d in mesh.devices)

    def bound(f, cards=1):
        return max((f * shard_bytes + cards * card_bytes) / HBM_BYTES_PER_S,
                   f * shard_ops / rate) * 1e3

    return _entry(
        name, launches, _max_abs_err(got, want), ms, plain_ms, k * shard_bytes + card_bytes,
        k * shard_ops, rate, library_ms, dev_ms, shards=mesh.size,
        devices=[str(d) for d in mesh.devices], bound_ms_per_shard=bound(1),
        bound_ms_whole=bound(mesh.size, len(set(mesh.devices))), **extra,
    )


def _per_call(dev_ms, launches_per_call):
    """The profiler's mean device ms per launch times the launches of one
    call: the kernels' device time per call, summed over the shards."""
    return dev_ms * launches_per_call if dev_ms else None


def old_sharded_cube(mesh):
    """The per-shard sharded cube kt_cube_fused replaces, rebuilt from
    public pieces for the before/after turns: per shard a pageable upload
    of each entity slab (split_rows), production_cube there (one kt_cube
    launch), then gather_rows."""
    from karpenter_tpu_torch import mesh as mesh_mod
    from karpenter_tpu_torch.ops import feasibility as feas

    def run(membership, req_compat, offer_compat, custom_need, key_present, available, owner):
        mem_s = mesh_mod.split_rows(membership, mesh)
        kp_s = mesh_mod.split_rows(key_present, mesh)
        rep = [mesh_mod.per_shard(x, mesh) for x in (req_compat, offer_compat, custom_need,
                                                     available, owner)]
        parts = [feas.production_cube(mem_s[s], rep[0][s], rep[1][s], rep[2][s], kp_s[s], rep[3][s],
                                      rep[4][s]) for s in range(mesh.size)]
        return (mesh_mod.gather_rows([p[0] for p in parts], mesh),
                mesh_mod.gather_rows([p[1] for p in parts], mesh))

    return run


def old_sharded_solve_block(mesh):
    """The per-shard sharded group solve the one launch a card replaces,
    rebuilt from public pieces: per shard a pageable upload of each entity
    slab, solve_block there (one kt_group_solve launch on the card's
    catalog copy, packed once, as every path reads it), then
    gather_rows."""
    from karpenter_tpu_torch import mesh as mesh_mod
    from karpenter_tpu_torch.ops import packer

    def run(group_bools, group_ints, *catalog):
        gb_s = mesh_mod.split_rows(group_bools, mesh)
        gi_s = mesh_mod.split_rows(group_ints, mesh)
        rep = [mesh_mod.per_shard(x, mesh) for x in catalog]
        return mesh_mod.gather_rows(
            [packer.solve_block(gb_s[s], gi_s[s], *(r[s] for r in rep)) for s in range(mesh.size)], mesh)

    return run


# the wrapper parts wrapper_breakdown times: label -> (module, attribute)
# pairs; a pair the module lacks is skipped, so one table serves the per-shard
# composition and the fused wrappers. Kernel launches are timed apart, by
# C entry point ("enqueue <entry>").
BREAKDOWN_PARTS = {
    "upload": [("mesh", "split_rows"), ("mesh", "stage_rows"), ("mesh", "upload_rows")],
    "packs": [("feas", "_cached")],
    "replicate": [("mesh", "per_shard")],
    "plan": [("mesh", "slab_plan")],
    "checks": [("feas", "_check"), ("packer", "_check")],
    "gather": [("mesh", "gather_rows"), ("mesh", "gather_cards")],
}


def wrapper_breakdown(run, reps=50, extra=()) -> dict:
    """Host microseconds of one call of `run` split by part: every part of
    BREAKDOWN_PARTS, every (label, owner, attribute) of `extra` that the
    owner has (a static method too) and every kernel launch wrapped in a
    timer over `reps` calls (each followed by a synchronize outside the
    timed call, after two warmup calls). `rest_us` is the call's host time
    outside the parts (Python, allocation, slicing). Parts never nest, so
    they add up."""
    import inspect

    from karpenter_tpu_torch import mesh as mesh_mod
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    mods = {"mesh": mesh_mod, "feas": feas, "packer": packer}
    acc: dict = {}

    def timed(label, fn):
        def shim(*a, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a, **kw)
            finally:
                acc[label] = acc.get(label, 0) + time.perf_counter_ns() - t0
        return shim

    def launch_timer(real):
        def shim(dev, entry, *args):
            t0 = time.perf_counter_ns()
            try:
                return real(dev, entry, *args)
            finally:
                label = f"enqueue {entry.__name__}"
                acc[label] = acc.get(label, 0) + time.perf_counter_ns() - t0
        return shim

    saved = []
    for label, targets in BREAKDOWN_PARTS.items():
        for mod, attr in targets:
            real = getattr(mods[mod], attr, None)
            if real is not None:
                saved.append((mods[mod], attr, real))
                setattr(mods[mod], attr, timed(label, real))
    for label, owner, attr in extra:
        try:
            static = inspect.getattr_static(owner, attr)
        except AttributeError:
            continue
        saved.append((owner, attr, static))
        if isinstance(static, staticmethod):
            setattr(owner, attr, staticmethod(timed(label, static.__func__)))
        else:
            setattr(owner, attr, timed(label, static))
    for mod in (feas, packer):
        saved.append((mod, "launch", mod.launch))
        mod.launch = launch_timer(mod.launch)
    total = 0
    try:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        acc.clear()
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            run()
            total += time.perf_counter_ns() - t0
            torch.cuda.synchronize()
    finally:
        for mod, attr, real in reversed(saved):
            setattr(mod, attr, real)
    parts = {k: v / reps / 1e3 for k, v in sorted(acc.items())}
    host = total / reps / 1e3
    return {"host_us": host, "parts_us": parts, "rest_us": host - sum(parts.values())}


def delta_pass_parts() -> tuple:
    """wrapper_breakdown's parts of a delta group pass (GroupResidency.solve):
    the groups' fingerprints, the frontier's group rows, the upload (one
    copy; before: mesh.upload_rows and two plain copies), the catalog
    operands and the copy back; the enqueue of each launch is timed
    anyway."""
    from karpenter_tpu_torch.ops import delta, packer

    return (("fingerprints", delta.GroupResidency, "fingerprints"),
            ("pack groups", packer, "_pack_groups"),
            ("upload", delta, "_upload_pass"), ("upload", delta, "_upload"),
            ("catalog args", packer.GroupSolver, "_catalog_args"),
            ("copy back", delta, "_download"))


def delta_group_pass_timings(workload, reps=40) -> dict:
    """The delta group pass on the workload's groups through
    GroupResidency.solve, the self-check off: cold (the residency dropped
    first), count-only (the same groups, counts up) and new shapes (three
    groups of a new request whose slots are forgotten before each call, so
    each call solves them as a frontier). Each checked against the full
    solve, then its host ms (median of `reps`, each ending in the copy
    back), its device operations and device ms a call (profiler) and its
    host time by part."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.ops import delta, packer

    engine, reqs, requests = workload
    solver = packer.GroupSolver(engine)
    base = packer.encode_pods_for_packer(engine, reqs, requests)
    more = packer.encode_pods_for_packer(engine, reqs + reqs[:5000], np.vstack([requests, requests[:5000]]))
    extra_req = np.tile(requests[:1], (3, 1))
    extra_req[:, engine.resource_dims[wk.RESOURCE_CPU]] = 3.0  # a request no shape has
    new = packer.encode_pods_for_packer(engine, reqs + [reqs[0]] * 3, np.vstack([requests, extra_req]))
    dmode0, every0 = delta.DELTA_MODE, delta.RESOLVE_FULL_EVERY
    delta.configure(mode="on", resolve_full_every=0)
    out = {}
    try:
        res = delta.group_residency(solver)
        res.invalidate("chip-smoke")
        solver.solve(base)
        base_fps = set(res.fingerprints(base))
        new_fps = [fp for fp in res.fingerprints(new) if fp not in base_fps]

        def cold():
            res.invalidate("chip-smoke")
            return solver.solve(base)

        def new_shapes():
            for fp in new_fps:
                res.slot_of.pop(fp, None)
            return solver.solve(new)

        for label, run, grouped in (("cold", cold, base), ("count-only", lambda: solver.solve(more), more),
                                    ("new shapes", new_shapes, new)):
            got, want = run(), solver._solve_full(grouped)
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), f"delta pass {label}: != full"
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                times.append((time.perf_counter() - t0) * 1e3)
            dev_ms = device_per_call(run)
            G = int(grouped.counts.size)
            out[label] = {"ms": statistics.median(times), "ms_min": min(times), "groups": G,
                          "solved": {"cold": G, "count-only": 0, "new shapes": len(new_fps)}[label],
                          "device_ms_by_kernel": dev_ms, "device_ops_per_call": _device_ops(dev_ms),
                          "breakdown": wrapper_breakdown(run, extra=delta_pass_parts())}
    finally:
        delta.configure(mode=dmode0, resolve_full_every=every0)
    return out


def launch_floor(reps=2000, rounds=5) -> dict:
    """The launch floor on this card: an empty kernel (csrc/feasibility.cu
    kt_noop) launched `reps` times back to back between CUDA events (ms a
    launch, median of `rounds`), its own device time from the profiler, and
    the host time of one launch through device.launch and of the bare
    ctypes call."""
    from karpenter_tpu_torch.device import launch
    from karpenter_tpu_torch.ops import feasibility as feas

    entry = feas._lib().kt_noop
    dev = torch.device("cuda", torch.cuda.current_device())
    for _ in range(100):
        launch(dev, entry)
    torch.cuda.synchronize()
    span, host, bare = [], [], []
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            assert launch(dev, entry) == 0
        host.append((time.perf_counter_ns() - t0) / reps / 1e3)
        end.record()
        end.synchronize()
        span.append(start.elapsed_time(end) / reps)
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            entry(stream)
        bare.append((time.perf_counter_ns() - t0) / reps / 1e3)
        torch.cuda.synchronize()
    dev_ms = device_kernel_ms(lambda: launch(dev, entry), ["noop_kernel"], reps=200)["noop_kernel"]
    return {"device_ms": dev_ms, "back_to_back_ms": statistics.median(span),
            "launch_host_us": statistics.median(host), "ctypes_host_us": statistics.median(bare),
            "reps": reps, "rounds": rounds}


# the kernels a sharded wrapper may launch, by the profiler's names: the
# per-shard composition's and the fused ones
CUBE_KERNELS = ["cube_kernel", "cube_fused_kernel"]
GROUP_KERNELS = ["cube_kernel", "group_solve_kernel"]


def device_per_call(fn, names=None, reps=20, rounds=3) -> dict:
    """Device ms per call of fn by kernel, from torch.profiler's CUDA
    activity: per round of `reps` calls (after one warmup) each kernel's
    mean ms per launch (its total over the launches the trace holds, so a
    trace that misses a launch does not lower it), the median over
    `rounds` rounds, times the launches a call makes (the trace's count
    over the calls, rounded). `names` None: every kernel in the trace.
    Kernels that did not run are left out; their sum is "total"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    means: dict = {}
    counts: dict = {}
    for _ in range(rounds):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = names or sorted({ev.key for ev in prof.key_averages()
                                if (getattr(ev, "self_device_time_total", 0.0) or 0.0) > 0})
        for name in seen:
            total, count = 0.0, 0
            for ev in prof.key_averages():
                if name in ev.key:
                    total += getattr(ev, "self_device_time_total", 0.0) or 0.0
                    count += ev.count
            if total and count:
                means.setdefault(name, []).append(total / 1e3 / count)
                counts.setdefault(name, []).append(count)
    out = {}
    for name, m in means.items():
        per_call = max(1, round(statistics.median(counts[name]) / reps))
        out[name] = statistics.median(m) * per_call
    out["total"] = sum(v for v in out.values()) if out else None
    out["launches_seen"] = {name: [c / reps for c in cs] for name, cs in counts.items()}
    return out


def bare_launch_ms(run, reps=50, rounds=5):
    """Device ms of the one kernel launch a call of `run` makes on a mesh
    of one card: the C entry point replayed with that call's own
    arguments (its staged rows and outputs held), `reps` times back to
    back between CUDA events, median of `rounds`. A bare launch enqueues
    faster than these kernels run, so the span is the kernels' and the
    gaps between them; the profiler's trace misses some launches of a
    short window (`launches_seen`). None when a call launches on more than
    one card."""
    from karpenter_tpu_torch import mesh as mesh_mod
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    seen, held = [], []
    real_launch, real_stage = feas.launch, mesh_mod.stage_rows

    def launch_shim(dev, entry, *args):
        seen.append((dev, entry, args))
        return real_launch(dev, entry, *args)

    def stage_shim(*args):
        out = real_stage(*args)
        held.append(out)
        return out

    feas.launch = packer.launch = launch_shim
    mesh_mod.stage_rows = stage_shim
    try:
        held.append(run())
    finally:
        feas.launch = packer.launch = real_launch
        mesh_mod.stage_rows = real_stage
    if len(seen) != 1:
        return None
    dev, entry, args = seen[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    times = []
    with torch.cuda.device(dev):
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                assert entry(*args, stream) == 0
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def card_overlap(fn, names, mesh, calls=10):
    """Whether one call's launches on distinct cards run at once: the
    profiler's device intervals of the kernels in `names` over `calls`
    calls (a synchronize after each), grouped per call; per call each
    card's [start, end] in us from the call's first start, and whether the
    latest start precedes the earliest end. None on a mesh of one card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cards = len(set(mesh.devices))
    if cards < 2:
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and any(n in e.name for n in names)), key=lambda e: e.time_range.start)
    per_call = []
    for k in range(0, len(evs) - cards + 1, cards):
        group = evs[k:k + cards]
        t0 = min(e.time_range.start for e in group)
        spans = {f"cuda:{e.device_index}": [e.time_range.start - t0, e.time_range.end - t0] for e in group}
        per_call.append({"spans_us": spans, "overlap": max(e.time_range.start for e in group)
                         < min(e.time_range.end for e in group)})
    return {"calls": len(per_call), "overlapping": sum(c["overlap"] for c in per_call),
            "first": per_call[0] if per_call else None}


def _old_wrapper(old) -> dict:
    """The per-shard composition on the same inputs: wrapper ms, device ms by
    kernel and the host breakdown."""
    return {"ms": cuda_ms(old), "device_ms_by_kernel": device_per_call(old, CUBE_KERNELS + GROUP_KERNELS),
            "breakdown": wrapper_breakdown(old)}


def in_turns(runs: dict, order=("old", "new", "new", "old"), rounds=11) -> list:
    """Wrapper ms per call (cuda_ms, median of `rounds`) of each labelled
    callable, in turns on one card."""
    return [{"which": w, "ms": cuda_ms(runs[w], rounds=rounds)} for w in order]


def mesh_entries(captured, launches, plain):
    """The sharded twins on the largest mesh's inputs from phase 5b, each
    against its plain version on the same inputs (the cube and the group
    solve unsharded on the first card; the classic and full scans against
    plain loop on phase 4's operands, which the mesh path's are checked
    equal to; the resume against the plain resume), then timed."""
    from karpenter_tpu_torch import mesh as mesh_mod
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    def words(n):
        return (n + 31) // 32

    def flat(args):
        return [a[0] if isinstance(a, tuple) else a for a in args]

    entries = []
    mesh, args = captured["sharded_cube"][1]
    n, dev0 = mesh.size, mesh.devices[0]
    card = [a.to(dev0) for a in flat(args)]
    run = lambda: feas.sharded_cube(mesh)(*args)  # noqa: E731
    got, want = run(), feas.production_cube_plain(*card)
    check_equal("sharded_cube on the mesh path's inputs", got, want)
    (P, R), I, (O, K) = card[0].shape, card[1].shape[1], card[3].shape
    old = lambda: old_sharded_cube(mesh)(*args)  # noqa: E731
    check_equal("the per-shard sharded cube on the mesh path's inputs", old(), want)
    # the entity rows on the first card: read in place there, copied card
    # to card for the others
    check_equal("sharded_cube with the entity rows on the first card",
                feas.sharded_cube(mesh)(card[0], *args[1:4], card[4], *args[5:]), want)
    dev_new = device_per_call(run, CUBE_KERNELS)
    entries.append(_sharded_entry(
        "sharded_cube", mesh, launches, got, want, cuda_ms(run),
        cuda_ms(lambda: feas.production_cube_plain(*card), reps=5, warmup=1),
        (nbytes(card[0], card[4]) + nbytes(*got)) / n,
        (P // n) * I * words(R) + (P // n) * O * (words(R) + words(K)), WORD_OPS_PER_S,
        cuda_ms(lambda: cube_f32(*card)), dev_new["total"],
        card_bytes=nbytes(card[1], card[2], card[3], card[5], card[6]),
        shapes=[list(t.shape) for t in card], library_call="the reference's f32 form, unsharded",
        device_ms_by="profiler, kernels' device time per call summed over the launches",
        device_ms_by_kernel=dev_new, breakdown=wrapper_breakdown(run),
        old=_old_wrapper(old), turns=in_turns({"old": old, "new": run}),
        overlap=card_overlap(run, ["cube_fused_kernel"], mesh),
        bare_launch_ms=bare_launch_ms(run),
    ))

    mesh, args, kw = captured["sharded_solve_block"][1]
    n, dev0 = mesh.size, mesh.devices[0]
    card = [a.to(dev0) for a in flat(args)]
    run = lambda: packer.sharded_solve_block(mesh)(*args, **kw)  # noqa: E731
    got, want = run(), packer.solve_block_plain(*card)
    check_equal("sharded_solve_block on the mesh path's inputs", got, want)
    G2 = card[0].shape[0]
    (R, I), (O, K), D = card[2].shape, card[4].shape, card[7].shape[1]
    m = G2 // n
    old = lambda: old_sharded_solve_block(mesh)(*args)  # noqa: E731
    check_equal("the per-shard sharded group solve on the mesh path's inputs", old(), want)
    check_equal("sharded_solve_block with the group rows on the first card",
                packer.sharded_solve_block(mesh)(card[0], card[1], *args[2:], **kw), want)
    dev_new = device_per_call(run, GROUP_KERNELS)
    entries.append(_sharded_entry(
        "sharded_solve_block", mesh, launches, got, want, cuda_ms(run),
        cuda_ms(lambda: packer.solve_block_plain(*card), reps=5, warmup=1),
        (nbytes(card[0], card[1]) + nbytes(got)) / n,
        m * I * words(R) + m * O * (words(R) + words(K)) + m * I * (D + 1), WORD_OPS_PER_S, None,
        dev_new["total"], card_bytes=nbytes(*card[2:]), shapes=[list(t.shape) for t in card],
        device_ms_by="profiler, kernels' device time per call summed over the launches",
        device_ms_by_kernel=dev_new, breakdown=wrapper_breakdown(run),
        old=_old_wrapper(old), turns=in_turns({"old": old, "new": run}),
        overlap=card_overlap(run, ["group_solve_kernel"], mesh),
        bare_launch_ms=bare_launch_ms(run),
    ))

    for name, mode, factory in (("sharded_solve_scan", "classic", packer.sharded_solve_scan),
                                ("sharded_solve_scan_full", "full", packer.sharded_solve_scan_full)):
        mesh, cfg, args = captured[f"sharded_solve_scan_{mode}"][1]
        pargs, want, plain_ms = plain["solve_scan" if mode == "classic" else "solve_scan_full"]
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(args, pargs)), \
            f"{name}: the mesh path's operands differ from phase 4's"
        run = lambda f=factory, m=mesh, c=cfg, a=args: f(m)(c, a)  # noqa: E731
        out = run()
        reps = [out] if mode == "classic" else out
        for rep in reps:
            check_equal(f"{name} replica on the main path's operands", tuple(rep), tuple(want))
        steps = int(reps[0][-1])
        G, D = args[2].shape
        U = args[4].shape[0]
        dev_ms, per_device = replicated_launch_ms(mesh, cfg, args)
        entries.append(_sharded_entry(
            name, mesh, launches, tuple(reps[0]), tuple(want), cuda_ms(run, reps=1, warmup=1, rounds=3),
            plain_ms, nbytes(*args) + nbytes(*reps[0]), steps * (G * U * D + 2 * U * D), F64_OPS_PER_S,
            None, dev_ms, steps=steps, plain_from="the plain loop on phase 4's operands",
            device_ms_per_device=per_device,
            replicate_ms=cuda_ms(lambda: [mesh_mod.per_shard(a, mesh) for a in args]),
            device_ms_by="CUDA events on every card around all the replicas' bare launches; the "
                         "largest span",
        ))

    mesh, cfg, args, states, p_lo = captured["sharded_solve_scan_resume"][1]
    fresh = lambda: [tuple(t.clone() for t in st) for st in states]  # noqa: E731
    run = lambda sts: packer.sharded_solve_scan_resume(mesh)(cfg, args, sts, p_lo)  # noqa: E731
    got = run(fresh())
    want = packer.solve_scan_resume_plain(cfg, args, fresh()[0], p_lo)
    for rep in got:
        check_equal("sharded_solve_scan_resume replica on the last churn pass's inputs",
                    tuple(rep), tuple(want))
    rsteps = int(got[0][-1])
    G, D = args[2].shape
    U = args[4].shape[0]
    entries.append(_sharded_entry(
        "sharded_solve_scan_resume", mesh, launches, tuple(got[0]), tuple(want),
        cuda_ms_fresh(fresh, run),
        cuda_ms_fresh(lambda: fresh()[0], lambda st: packer.solve_scan_resume_plain(cfg, args, st, p_lo),
                      rounds=1),
        resume_bytes(cfg, args, states[0], got[0][:-1], p_lo), rsteps * (G * U * D + 2 * U * D),
        F64_OPS_PER_S, None,
        _per_call(_dev_sum(device_kernel_ms(lambda: run(fresh()), SCAN_KERNELS, reps=5)),
                  mesh.size),
        steps=rsteps, p_lo=int(p_lo),
        device_ms_by="profiler, kernels' device time per call summed over the replicas",
    ))
    return entries


def sweep_turns(engine, dev) -> tuple:
    """The catalog sweep's wrappers in one checkout, through entry points
    older checkouts have too, each in the way the checkout's engine
    composes them (see --turns): B1 on a fresh 7-row batch against the types and
    the offerings; B3 at phase 4's sweep shape (16 of the workload's
    selector sets), the engine's kernels (cube_rows where the checkout has
    it, else the two gathers and production_cube) and production_cube
    alone on the gathered rows; the whole CatalogEngine.feasibility sweep.
    Returns the {name: (run, check)} of those and a callable that runs one
    fresh row batch through _ensure_rows (the time-consuming part is the
    caller's)."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.ops import encoding as enc
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.scheduling.requirements import Operator, Requirement, Requirements

    # fresh rows that intern no new value: instance-type pairs, 7 a batch
    pairs = itertools.combinations([it.name for it in construct_instance_types()], 2)

    def fresh_batch():
        return [Requirement(wk.LABEL_INSTANCE_TYPE, Operator.IN, list(next(pairs))) for _ in range(7)]

    engine.warmup()
    er = enc.encode_requirement_rows(engine.vocab, fresh_batch(), engine._word_capacity)
    rows = tuple(_to(a, dev) for a in (er.key, er.complement, er.has_values, er.gt, er.lt, er.mask))
    sets = [engine._set_args("inst", engine._inst_sets), engine._set_args("offer", engine._offer_sets)]
    tables = (engine._dev("slot_key", engine._tables.slot_key),
              engine._dev("value_int", engine._tables.value_int))
    want_rows = [feas.req_rows_vs_sets_plain(*rows, *t, *tables) for t in sets]
    if hasattr(feas, "req_rows_vs_targets"):
        table = _to(feas.row_table(er.key, er.complement, er.has_values, er.gt, er.lt, er.mask), dev)
        b1 = lambda: feas.req_rows_vs_targets(table, sets, *tables)  # noqa: E731
        b1_want = torch.cat(want_rows, dim=1)
    else:
        b1 = lambda: tuple(feas.req_rows_vs_sets(*rows, *t, *tables) for t in sets)  # noqa: E731
        b1_want = tuple(want_rows)

    # phase 4's sweep shape: 16 selector sets of the workload
    shapes, _ = bench_shapes()
    selectors = list(dict.fromkeys(tuple(sorted(sel.items())) for sel, _ in shapes))[:16]
    reqs = [Requirements(*(Requirement(k, Operator.IN, [v]) for k, v in sel)) for sel in selectors]
    row_sets = [engine.rows_for(r) for r in reqs]
    key_present = engine.key_presence(reqs)
    engine._ensure_rows()
    used = sorted({rid for rs in row_sets for rid in rs if not engine._row_trivial[rid]})
    P, R = len(row_sets), len(used)
    P2, R2 = 1 << max(0, (P - 1).bit_length()), 1 << max(0, (max(R, 1) - 1).bit_length())
    membership = np.zeros((P2, R2), dtype=bool)
    for p, rs in enumerate(row_sets):
        for rid in rs:
            if rid in used:
                membership[p, used.index(rid)] = True
    kp = np.zeros((P2, key_present.shape[1]), dtype=bool)
    kp[:P] = key_present
    mem_d, kp_d = _to(membership, dev), _to(kp, dev)
    rc_d, oc_d = engine._req_compat_d, engine._offer_compat_d
    cat = (engine._dev("custom_need", engine.offering_custom_need),
           engine._dev("available", engine.offering_available), engine._dev("owner", engine.offering_owner))
    idx64 = _to(np.asarray(used, dtype=np.int64), dev)
    rc_g, oc_g = engine._gather_rows(rc_d, idx64, R2), engine._gather_rows(oc_d, idx64, R2)
    want_cube = feas.production_cube_plain(mem_d[:, :R], rc_d[idx64], oc_d[idx64], cat[0], kp_d, *cat[1:])
    if hasattr(feas, "cube_rows"):
        idx32 = _to(np.asarray(used, dtype=np.int32), dev)
        b3 = lambda: feas.cube_rows(mem_d, kp_d, idx32, rc_d, oc_d, *cat)  # noqa: E731
        b3_want = torch.stack(want_cube)
    else:
        b3 = lambda: feas.production_cube(  # noqa: E731
            mem_d, engine._gather_rows(rc_d, idx64, R2), engine._gather_rows(oc_d, idx64, R2), cat[0],
            kp_d, *cat[1:])
        b3_want = want_cube
    cube = lambda: feas.production_cube(mem_d, rc_g, oc_g, cat[0], kp_d, *cat[1:])  # noqa: E731
    requests = np.zeros((P, len(engine.resource_dims)), dtype=np.float32)
    sweep = lambda: engine.feasibility(row_sets, requests, key_present)  # noqa: E731

    def sweep_check():
        f = sweep()
        check_equal("the sweep on the workload", (torch.from_numpy(f.compat), torch.from_numpy(f.has_offering)),
                    tuple(w[:P].cpu() for w in want_cube))

    # every batch lands on the same resident rows: the engine's row state
    # is put back before each (the host copy of the matrices grows with
    # every batch otherwise, and its concatenation would be what is timed)
    base = {k: getattr(engine, k) for k in (
        "_rows", "_row_ids", "_computed_rows", "_req_compat", "_offer_compat", "_req_compat_d",
        "_offer_compat_d", "_row_trivial")}

    def row_batch():
        for k, v in base.items():
            setattr(engine, k, v.copy() if isinstance(v, (list, dict)) else v)
        for r in fresh_batch():
            engine.row_id(r)
        engine._ensure_rows()

    label = f"P={P2} R={R} R2={R2}"
    runs = {
        "B1 row batch vs types and offerings": (b1, lambda: check_equal("B1", b1(), b1_want)),
        f"B3 the sweep's kernels ({label})": (b3, lambda: check_equal("B3", b3(), b3_want)),
        f"B3 production_cube ({label})": (cube, lambda: check_equal("production_cube", cube(), want_cube)),
        "CatalogEngine.feasibility sweep": (sweep, sweep_check),
    }
    return runs, row_batch


def famu_turns(dev) -> dict:
    """B6 in one checkout, at the workload's famu_ok shape (T=1, F=64,
    U=36, I=1008; seeded masks): the famu_ok build from the host masks
    (fused._FusedSolve._famu_ok where the checkout has it, else the
    composition its fused solve ran: three uploads, the product mask, then
    uid_project) and its device work alone on masks already on the card
    (uid_project_factored, else the product mask and uid_project)."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import fused

    T, F, U, I = 1, 64, 36, 1008
    onehot_d, tmpl_d, fam_d = random_famu_inputs(np.random.RandomState(9), T, F, U, I, dev)
    onehot, tmpl, fam = (t.cpu().numpy() for t in (onehot_d, tmpl_d, fam_d))
    masks = np.concatenate([onehot, fam, tmpl])
    want = feas.uid_project_plain(onehot_d, tmpl_d[:, None, :] & fam_d[None, :, :])
    if hasattr(fused._FusedSolve, "_famu_ok"):
        build = lambda: fused._FusedSolve._famu_ok(masks, U, F, dev)[0]  # noqa: E731
        alone = lambda: feas.uid_project_factored(onehot_d, tmpl_d, fam_d)  # noqa: E731
    else:
        def build():
            o, f, t = (torch.from_numpy(a).to(dev) for a in (onehot, fam, np.ascontiguousarray(tmpl)))
            return feas.uid_project(o, t[:, None, :] & f[None, :, :])

        alone = lambda: feas.uid_project(onehot_d, tmpl_d[:, None, :] & fam_d[None, :, :])  # noqa: E731
    return {
        "B6 famu_ok build, host masks to famu_ok": (build, lambda: check_equal("B6 build", build(), want)),
        "B6 famu_ok on the card's masks": (alone, lambda: check_equal("B6", alone(), want)),
    }


def delta_turns(full, dev) -> dict:
    """B12 in one checkout: a delta pass's kernels on the workload's first
    128 groups as the frontier into a 256-row core matrix and an order of
    the 200 groups (the frontier's slots and 72 older rows, edge-padded to
    256) with their counts: delta_pass where the checkout has it, else
    solve_block_scatter then delta_finalize."""
    from karpenter_tpu_torch.ops import packer

    rng = np.random.RandomState(12)
    Fr, cap, G = 128, 256, 200
    gb, gi = full[0][:Fr].contiguous(), full[1][:Fr].contiguous()
    cat = full[2:]
    perm = rng.permutation(cap).astype(np.int32)
    slots = _to(perm[:Fr], dev)
    order = _to(np.pad(np.concatenate([perm[:Fr], rng.choice(perm[Fr:], size=G - Fr)]), (0, cap - G),
                       mode="edge").astype(np.int32), dev)
    counts = _to(np.pad(rng.randint(0, 900, size=G).astype(np.int32), (0, cap - G)), dev)
    core0 = _to(np.stack([rng.randint(0, 1008, size=cap), rng.randint(0, 2, size=cap),
                          rng.randint(0, 200, size=cap)], axis=1).astype(np.int32), dev)
    want_core = core0.clone()
    packer.solve_block_scatter_plain(want_core, slots, gb, gi, *cat)
    want = packer.delta_finalize_plain(want_core, order, counts)
    core = core0.clone()
    if hasattr(packer, "delta_pass"):
        counter = torch.zeros(1, dtype=torch.int32, device=dev)

        def run():
            return packer.delta_pass(core, slots, gb, gi, order, counts, *cat, counter=counter)
    else:
        def run():
            packer.solve_block_scatter(core, slots, gb, gi, *cat)
            return packer.delta_finalize(core, order, counts)

    def check():
        check_equal("B12", run(), want)
        check_equal("B12 core", core, want_core)

    return {"B12 a delta pass's kernels (128-group frontier, 256 groups)": (run, check)}


def _device_ops(dev_ms: dict) -> float:
    """Device operations a call (kernels and copies) from device_per_call's
    launches_seen."""
    return sum(statistics.median(v) for v in dev_ms["launches_seen"].values())


def turns_of(tree: str) -> dict:
    """One checkout's group and sweep wrappers on the bench workload (see
    --turns), timed by this script's helpers; the checkout's
    karpenter_tpu_torch is first on sys.path."""
    import karpenter_tpu_torch
    from karpenter_tpu_torch import device
    from karpenter_tpu_torch.mesh import Mesh
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    assert os.path.dirname(karpenter_tpu_torch.__file__).startswith(tree), karpenter_tpu_torch.__file__
    dev = torch.device("cuda", 0)
    device.build_kernels()
    engine = CatalogEngine(build_catalog(), device=dev)
    reqs, requests = packer_workload(engine)
    solver = packer.GroupSolver(engine)
    gb, gi = packer._pack_groups(packer.encode_pods_for_packer(engine, reqs, requests))
    cat = solver._catalog_args()
    full = (_to(gb, dev), _to(gi, dev)) + cat
    F, cap = 128, 256
    front = (full[0][:F].contiguous(), full[1][:F].contiguous()) + cat
    rows = packer.solve_block_core_plain(*front)
    slots = _to(np.random.RandomState(5).permutation(cap)[:F].astype(np.int32), dev)
    core0 = torch.zeros((cap, 3), dtype=torch.int32, device=dev)
    mesh = Mesh([dev, dev])
    pad = ((0, cap - gb.shape[0]), (0, 0))
    mesh_rows = (torch.from_numpy(np.pad(gb, pad)), torch.from_numpy(np.pad(gi, pad)))
    mesh_cat = solver._mesh_catalog_args(mesh)
    c_k, c_l = core0.clone(), core0.clone()

    def checked(name, run, plain):
        return run, lambda: check_equal(f"{name} on the workload", run(), plain())

    runs = {
        "B9 solve_block": checked("B9", lambda: packer.solve_block(*full),
                                  lambda: packer.solve_block_plain(*full)),
        "B10 solve_block_core": checked("B10", lambda: packer.solve_block_core(*front),
                                        lambda: packer.solve_block_core_plain(*front)),
        "B11 delta_scatter_rows": checked(
            "B11", lambda: packer.delta_scatter_rows(c_k, slots, rows),
            lambda: packer.delta_scatter_rows_plain(core0.clone(), slots, rows)),
        "B13 sharded_solve_block": checked(
            "B13", lambda: packer.sharded_solve_block(mesh)(*mesh_rows, *mesh_cat),
            lambda: packer.solve_block_plain(*(t.to(dev) for t in mesh_rows), *cat)),
    }
    sweep_engine = CatalogEngine(build_catalog(), device=dev)
    sweep_runs, row_batch = sweep_turns(sweep_engine, dev)
    runs.update(sweep_runs)
    runs.update(famu_turns(dev))
    runs.update(delta_turns(full, dev))
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "kernels": {}}
    real = feas.launch

    def per_call_launches(run):
        counts: dict = {}

        def shim(d, entry, *a):
            counts[entry.__name__] = counts.get(entry.__name__, 0) + 1
            return real(d, entry, *a)

        feas.launch = packer.launch = shim
        try:
            run()
        finally:
            feas.launch = packer.launch = real
        torch.cuda.synchronize()
        return counts

    for name, (run, check) in runs.items():
        check()
        launches = per_call_launches(run)
        dev_ms = device_per_call(run)
        out["kernels"][name] = {"ms": cuda_ms(run), "launches_per_call": launches,
                                "device_ms_by_kernel": dev_ms, "device_ops_per_call": _device_ops(dev_ms),
                                "breakdown": wrapper_breakdown(run)}
    # a fresh row batch each call: host clock around _ensure_rows (its copy
    # back synchronizes), the interning of the batch outside the timer;
    # device time, operations and host parts with the interning inside
    times = []
    for k in range(60):
        t0 = time.perf_counter()
        row_batch()
        times.append((time.perf_counter() - t0) * 1e3)
    dev_ms = device_per_call(row_batch)
    out["kernels"]["CatalogEngine._ensure_rows, a fresh 7-row batch"] = {
        "ms": statistics.median(times[10:]),
        "ms_includes": "putting the engine's row state back and interning the 7 rows",
        "resident_rows_after": sweep_engine.num_rows,
        "launches_per_call": per_call_launches(row_batch), "device_ms_by_kernel": dev_ms,
        "device_ops_per_call": _device_ops(dev_ms), "breakdown": wrapper_breakdown(row_batch)}
    scatter = runs["B11 delta_scatter_rows"][0]
    slots_l = slots.long()  # index_put_ takes int64 indices: converted once, outside the timing
    index_put = lambda: c_l.index_put_((slots_l,), rows)  # noqa: E731
    out["kernels"]["B11 delta_scatter_rows"]["turns"] = [
        {"which": w, "ms": cuda_ms(f, rounds=41)}
        for w, f in (("kernel", scatter), ("index_put_", index_put), ("index_put_", index_put),
                     ("kernel", scatter))]
    # the delta group pass through GroupResidency.solve (host clock; device
    # operations and host parts as above)
    for label, rec in delta_group_pass_timings((engine, reqs, requests)).items():
        out["kernels"][f"delta group pass, {label}"] = rec
    return out


def run_turns(trees) -> int:
    """--turns: each checkout in a process of its own, in the order given."""
    here = os.path.abspath(__file__)
    results = []
    for k, tree in enumerate(trees):
        proc = subprocess.run([sys.executable, here, "--turns-of", os.path.abspath(tree)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["turn"] = k
        results.append(res)
        log(json.dumps(res))
    os.makedirs(os.path.join(os.path.dirname(here), "chiprun_out"), exist_ok=True)
    with open(os.path.join(os.path.dirname(here), "chiprun_out", "turns.json"), "w") as f:
        json.dump(results, f, indent=1)
    for name in results[0]["kernels"]:
        log(f"{name}: " + json.dumps([(r["turn"], r["kernels"][name]["ms"],
                                       r["kernels"][name]["device_ms_by_kernel"]["total"],
                                       r["kernels"][name]["breakdown"]["host_us"],
                                       r["kernels"][name]["device_ops_per_call"]) for r in results]))
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true", help="build and check kernels only")
    parser.add_argument("--mesh", action="store_true",
                        help="build, then phase 4 and the mesh phase alone, with the sharded "
                             "twins' entries (for a machine with two or more cards)")
    parser.add_argument("--turns", nargs="+", metavar="TREE",
                        help="time the group and sweep wrappers of each checkout in turns, in the "
                             "order given")
    parser.add_argument("--turns-of", metavar="TREE", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card", file=sys.stderr)
        return 2
    if args.turns_of:
        sys.path.insert(0, args.turns_of)
        print(json.dumps(turns_of(args.turns_of)), flush=True)
        return 0
    if args.turns:
        phase_device()
        return run_turns(args.turns)
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "karpenter_tpu_torch")):
        print(f"chip_smoke: no karpenter_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    captured: dict = {}
    if args.mesh:
        phase_main(captured)
        log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
        phase_topology(captured)
        log(f"phase 5c done at {time.perf_counter() - t_start:.1f} s")
        mesh_launches = phase_mesh(captured)
        log(f"phase 5b done at {time.perf_counter() - t_start:.1f} s")
        plain: dict = {}
        plain_scans(captured, plain)
        log(json.dumps({"mesh_kernels": mesh_entries(captured, mesh_launches, plain)}))
        return finish(t_start)
    l0 = _count_launches()
    phase_kernel_checks()
    # phase 3's launches of the wrappers no path runs, for their phase-7
    # entries' check_launches
    phase3 = {k: _count_launches()[k] - l0[k] for k in OFF_PATH}
    fits_stage_checks(captured)
    log(f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")
    if not args.quick:
        launches = phase_main(captured)
        log(f"phase 4 done at {time.perf_counter() - t_start:.1f} s")
        delta_launches = phase_delta(captured)
        group_launches = phase_group(captured)
        log(f"phase 5 done at {time.perf_counter() - t_start:.1f} s")
        phase_topology(captured)
        log(f"phase 5c done at {time.perf_counter() - t_start:.1f} s")
        phase_observatory(captured)
        log(f"phase 4c done at {time.perf_counter() - t_start:.1f} s")
        mesh_launches = phase_mesh(captured)
        log(f"phase 5b done at {time.perf_counter() - t_start:.1f} s")
        prefix_scan = phase_identity()
        from karpenter_tpu_torch.ops import feasibility as feas

        # the sweep at the sizes a more diverse backlog reaches (256 joint
        # sets x 128 rows), beside the sizes this workload gave
        rng = np.random.RandomState(1)
        dev = torch.device("cuda")
        rows, targets, sk, vi = random_target_inputs(rng, 128, (1008, 8064), 8, 8, dev, 0.2, 0.3)
        wide = timing_entries(
            (feas.row_table(*rows), targets, sk, vi),
            random_sweep_inputs(rng, 256, 128, 300, 1008, 8064, 8, dev),
            launches, "synthetic sweep-size inputs",
        )
        log(json.dumps({"kernels_at_sweep_size": [
            {k: e[k] for k in ("name", "ms", "plain_ms", "library_ms", "device_ms",
                               "bound_ms", "bound_by", "bytes", "ops", "shapes")}
            for e in wide]}))
        kernels = timing_entries(captured["row_compat"], captured["cube"], launches,
                                 "the main path's inputs", phase3)
        plain: dict = {}
        kernels += scan_entries(captured["uid_project"], captured["solve_scan"], prefix_scan,
                                launches, plain)
        kernels += scan_state_entries(captured["solve_scan"], captured["solve_scan_resume"],
                                      delta_launches, plain)
        kernels += group_entries(captured, group_launches, phase3)
        kernels += fits_stage_entries(captured, launches)
        kernels += mesh_entries(captured, mesh_launches, plain)
        log(json.dumps({"launch_floor": launch_floor()}))
        log(json.dumps({"dispatch_floor": dispatch_floor()}))
        assert len(kernels) == len(SOURCE) == len(ENTRY_POINTS), [k["name"] for k in kernels]
        for k in kernels:
            if k["name"] in OFF_PATH:
                # no path runs it: none of its launches may come from a path,
                # and its checks must have launched it
                assert k["launches"] == 0 and k["check_launches"] > 0, \
                    f"{k['name']}: {k['launches']} launches on a path, {k['check_launches']} checked"
            else:
                assert k["launches"] > 0, f"{k['name']} was not launched on its path"
        log(json.dumps({"kernels": kernels}))
    return finish(t_start)


def finish(t_start) -> int:
    """The card's name and power limit, the total time, then the last line."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
