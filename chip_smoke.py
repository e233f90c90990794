#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-3 only (build + kernel checks)

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from karpenter_tpu_torch/csrc (nvcc, sm_90a);
  3. hold each kernel against its plain torch version on the card, bit for
     bit, at the solve's shapes, on ragged edges and on bounded/complement
     rows;
  4. the slice: the bench workload (kwok catalog x7 = 1008 types and 8064
     offerings, 50,000 pods from 200 shapes drawn with RandomState(7), one
     `default` NodePool, empty cluster) through the port's Scheduler.solve
     with a CUDA CatalogEngine, cold once and warm twice; launch counts are
     zeroed just before and read just after;
  5. decision identity on a 5,000-pod prefix: a CUDA engine against a
     device="cpu" engine (the plain versions);
  6. one JSON line {"kernels": [...]}: per kernel its launches in phase 4,
     agreement with the plain version, and CUDA-event medians of the kernel,
     the plain version and a PyTorch yardstick on the inputs phase 4 gave it,
     beside its bound (the larger of bytes over the memory rate and 32-bit
     word operations over the integer/logic rate);
  7. last line {"ok": true, "device": {...}}.

Imports torch, numpy and karpenter_tpu_torch only.
"""

from __future__ import annotations

import argparse
import copy
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
NUM_PODS = 50_000
CATALOG_REPEAT = 7
PREFIX_PODS = 5_000
SOURCE = "karpenter_tpu_torch/csrc/feasibility.cu"
REPLACES = {
    "row_compat": "karpenter_tpu/ops/feasibility.py:48",
    "membership": "karpenter_tpu/ops/feasibility.py:177",
    "cube": "karpenter_tpu/ops/feasibility.py:265",
}


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


def build_pods():
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.apis.core import Condition, Container, ObjectMeta, Pod, PodSpec
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
    picks = rng.randint(len(shapes), size=NUM_PODS)
    pods = []
    for i, s in enumerate(picks):
        sel, requests = shapes[s]
        pod = Pod(
            metadata=ObjectMeta(name=f"pod-{i:05d}", uid=f"uid-{i:05d}"),
            spec=PodSpec(node_selector=dict(sel), containers=[Container(requests=dict(requests))]),
        )
        pod.metadata.creation_timestamp = float(i % 13)
        pod.status.conditions.append(
            Condition(type="PodScheduled", status="False", reason="Unschedulable")
        )
        pods.append(pod)
    return pods


def solve(engine, catalog, pods):
    from karpenter_tpu_torch.apis.core import ObjectMeta
    from karpenter_tpu_torch.apis.nodepool import NodePool
    from karpenter_tpu_torch.events.recorder import Recorder
    from karpenter_tpu_torch.runtime.store import Store
    from karpenter_tpu_torch.scheduler.scheduler import Scheduler
    from karpenter_tpu_torch.scheduler.topology import Topology
    from karpenter_tpu_torch.state.cluster import Cluster
    from karpenter_tpu_torch.utils.clock import FakeClock

    clock = FakeClock()
    store = Store(clock=clock)
    cluster = Cluster(clock, store, cloud_provider=None)
    pool = NodePool(metadata=ObjectMeta(name="default"))
    pool.set_condition("Ready", "True")
    store.create(pool)
    its = {"default": catalog}
    t0 = time.perf_counter()
    topology = Topology(store, cluster, [], [pool], its, pods)
    scheduler = Scheduler(
        store, [pool], cluster, [], topology, its, [], Recorder(clock=clock), clock,
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
    return claims, errors


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
            if "registers" in line or "error" in line.lower() or "spill" in line:
                log(f"  {name}: {line.strip()}")


def check_equal(name: str, got, want) -> None:
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        for i, (g, w) in enumerate(zip(got, want)):
            check_equal(f"{name}[{i}]", g, w)
        return
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel disagrees with plain version ({bad} cells)")


def phase_kernel_checks(dev=torch.device("cuda")):
    from karpenter_tpu_torch.ops import feasibility as feas

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
    log(f"kernel checks: {n} cases bit-identical to the plain versions")


def phase_slice(captured, device=None):
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import ffd, native
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    catalog = build_catalog()
    pods = build_pods()
    engine = CatalogEngine(catalog, device=device)  # None: the current CUDA device
    log(f"workload: {engine.num_instances} types, {engine.num_offerings} offerings, "
        f"{len(pods)} pods, engine on {engine.device}")

    # record the largest inputs each kernel sees on the main path, to time
    # the kernels on them afterwards (recording does not launch anything)
    real_rows, real_cube = feas.req_rows_vs_sets, feas.production_cube

    def rows_shim(*args):
        if "row_compat" not in captured or args[6].shape[0] >= captured["row_compat"][6].shape[0]:
            captured["row_compat"] = args
        return real_rows(*args)

    def cube_shim(*args):
        if "cube" not in captured or args[0].numel() >= captured["cube"][0].numel():
            captured["cube"] = args
        return real_cube(*args)

    native_runs = []
    real_drive = ffd._NativeDriver.drive

    def drive_shim(self):
        native_runs.append(1)
        return real_drive(self)

    feas.req_rows_vs_sets, feas.production_cube = rows_shim, cube_shim
    ffd._NativeDriver.drive = drive_shim
    try:
        solves0 = ffd.DEVICE_SOLVES
        feas.reset_launch_counts()
        runs = []
        for label in ("cold", "warm", "warm"):
            before = dict(feas.LAUNCHES)
            results, ms = solve(engine, catalog, copy.deepcopy(pods))
            runs.append((label, ms, results,
                         {k: v - before[k] for k, v in feas.LAUNCHES.items()}))
        launches = dict(feas.LAUNCHES)
    finally:
        feas.req_rows_vs_sets, feas.production_cube = real_rows, real_cube
        ffd._NativeDriver.drive = real_drive
    for label, ms, results, per_solve in runs:
        placed = sum(len(nc.pods) for nc in results.new_node_claims)
        log(f"solve {label}: {ms:.1f} ms wall, {len(results.new_node_claims)} nodeclaims, "
            f"{placed} pods placed, {len(results.pod_errors)} pod errors, "
            f"launches {json.dumps(per_solve)}")
    log(f"device solves {ffd.DEVICE_SOLVES - solves0}, native driver runs {len(native_runs)} "
        f"(library {'loaded' if native.get_lib() is not None else 'MISSING'}), "
        f"kernel launches {json.dumps(launches)}")
    assert ffd.DEVICE_SOLVES - solves0 == len(runs), "a solve left the device path"
    assert len(native_runs) == len(runs), "the native driver did not run every solve"
    for name in ("row_compat", "membership", "cube"):
        assert launches[name] > 0, f"{name} never launched on the main path"
    first = decisions(runs[0][2])
    for label, _, results, _ in runs:
        claims, errors = decisions(results)
        assert not errors, f"{label}: {len(errors)} pod errors"
        uids = [u for c in claims for u in c[0]]
        assert len(uids) == len(set(uids)) == len(pods), f"{label}: pods placed != pods"
        assert (claims, errors) == first, f"{label}: decisions differ from the cold solve"
    profile_warm_solve(engine, catalog, pods)
    return launches


def profile_warm_solve(engine, catalog, pods):
    """One more warm solve, after the launch counts were read: its device
    busy time from torch.profiler and its host time by function from
    cProfile (the top entries here, the full table under chiprun_out/)."""
    import cProfile
    import io
    import pstats

    from torch.profiler import ProfilerActivity, profile

    solve_pods = copy.deepcopy(pods)
    prof = cProfile.Profile()
    with profile(activities=[ProfilerActivity.CUDA]) as tprof:
        prof.enable()
        _, ms = solve(engine, catalog, solve_pods)
        prof.disable()
    busy_us = sum(getattr(e, "self_device_time_total", 0.0) or 0.0 for e in tprof.key_averages())
    log(f"profiled warm solve: {ms:.1f} ms wall (cProfile on), device busy "
        f"{busy_us / 1e3:.4f} ms = {busy_us / 1e3 / ms:.6f} of wall")
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(12)
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    start = next(i for i, ln in enumerate(lines) if ln.lstrip().startswith("ncalls"))
    for ln in lines[start:start + 13]:
        log(f"  host {ln.strip()}")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "warm_solve_profile.txt"), "w") as f:
        pstats.Stats(prof, stream=f).sort_stats("cumulative").print_stats(60)


def phase_identity(devices=("cuda", "cpu", "cuda")):
    from karpenter_tpu_torch.ops.catalog import CatalogEngine
    from karpenter_tpu_torch.scheduler import nodeclaim as ncmod

    catalog = build_catalog()
    pods = build_pods()[:PREFIX_PODS]
    out = {}
    for dev in devices:
        ncmod._hostname_counter = itertools.count(1)
        results, ms = solve(CatalogEngine(catalog, device=dev), catalog, copy.deepcopy(pods))
        out.setdefault(dev, decisions(results))
        assert decisions(results) == out[dev], f"{dev}: decisions changed between runs"
        log(f"prefix {PREFIX_PODS} pods on {dev}: {ms:.1f} ms, "
            f"{len(results.new_node_claims)} nodeclaims, {len(results.pod_errors)} pod errors")
    first = out[devices[0]]
    for dev in devices[1:]:
        assert out[dev] == first, f"{devices[0]} and {dev} engines decided differently"
    log(f"decision identity: {' == '.join(sorted(set(devices)))} on the {PREFIX_PODS}-pod "
        f"prefix ({len(first[0])} claims)")


def device_kernel_ms(fn, names, reps=20) -> dict:
    """Per-kernel device time (ms per call) from torch.profiler's CUDA
    activity for `reps` calls of fn; None where the trace shows none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        total = 0.0
        for ev in prof.key_averages():
            if name in ev.key:
                total += getattr(ev, "self_device_time_total", 0.0) or 0.0
        out[name] = total / 1e3 / reps if total else None
    return out


def timing_entries(rows, cube, launches, label):
    """One entry per kernel on the given inputs: the kernel must match its
    plain version there, then the wrapper, the plain version and the
    yardstick are timed with CUDA events and the kernel's device time is
    read from the profiler."""
    from karpenter_tpu_torch.ops import feasibility as feas

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    membership_args = (cube[0], cube[1])
    entries = []

    def words(n):
        return (n + 31) // 32

    def entry(name, kernel, plain, library, inputs, device_names, word_ops):
        got, want = kernel(), plain()
        check_equal(f"{name} on {label}", got, want)
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        err = max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
                  for g, w in zip(gots, wants))
        moved = nbytes(*inputs) + nbytes(*gots)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = word_ops / WORD_OPS_PER_S * 1e3
        dev_ms = device_kernel_ms(kernel, device_names)
        entries.append({
            "name": name,
            "route": "cuda",
            "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": launches[name],
            "max_abs_err": err,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain, reps=5, warmup=1),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": cuda_ms(library) if library is not None else None,
            "device_ms": (sum(v for v in dev_ms.values() if v is not None)
                          if any(v is not None for v in dev_ms.values()) else None),
            "bytes": moved,
            "word_ops": word_ops,
            "shapes": [list(t.shape) for t in inputs],
        })

    # word ops the functions need: one AND per mask word of each (row, set)
    # pair; one AND per 32-row word of each (entity, target) pair, plus the
    # custom-key words per (entity, offering)
    (R, W), N = rows[5].shape, rows[6].shape[0]
    (P, Rc), I, (O, K) = cube[0].shape, cube[1].shape[1], cube[3].shape
    entry("row_compat", lambda: feas.req_rows_vs_sets(*rows),
          lambda: feas.req_rows_vs_sets_plain(*rows), None, rows, ["row_compat_kernel"],
          R * N * W)
    entry("membership", lambda: feas.membership_all(*membership_args),
          lambda: feas.membership_all_plain(*membership_args),
          lambda: (membership_args[0].float() @ (~membership_args[1]).float()) < 0.5,
          membership_args, ["membership_kernel"], P * I * words(Rc))
    entry("cube", lambda: feas.production_cube(*cube),
          lambda: feas.production_cube_plain(*cube),
          lambda: cube_f32(*cube), cube, ["membership_kernel", "cube_offer_kernel"],
          P * I * words(Rc) + P * O * (words(Rc) + words(K)))
    return entries


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--quick", action="store_true", help="build and check kernels only")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one card", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "karpenter_tpu_torch")):
        print(f"chip_smoke: no karpenter_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    torch.set_num_threads(min(8, os.cpu_count() or 1))

    t_start = time.perf_counter()
    phase_device()
    phase_build()
    phase_kernel_checks()
    if not args.quick:
        captured: dict = {}
        launches = phase_slice(captured)
        phase_identity()
        # the sweep at the sizes a more diverse backlog reaches (256 joint
        # sets x 128 rows), beside the sizes this workload gave
        rng = np.random.RandomState(1)
        dev = torch.device("cuda")
        wide = timing_entries(
            random_row_inputs(rng, 128, 8064, 8, 8, dev, 0.2, 0.3),
            random_cube_inputs(rng, 256, 128, 1008, 8064, 8, dev),
            launches, "synthetic sweep-size inputs",
        )
        log(json.dumps({"kernels_at_sweep_size": [
            {k: e[k] for k in ("name", "ms", "plain_ms", "library_ms", "device_ms",
                               "bound_ms", "bound_by", "bytes", "word_ops", "shapes")}
            for e in wide]}))
        kernels = timing_entries(captured["row_compat"], captured["cube"], launches,
                                 "the main path's inputs")
        log(json.dumps({"kernels": kernels}))
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
