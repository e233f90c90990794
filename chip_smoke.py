#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (karpenter_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # phases 1-3 only (build + kernel checks)

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the CUDA kernels from karpenter_tpu_torch/csrc (nvcc, sm_90a, one
     nvcc per source, all started together) and print ptxas's registers and
     spills per kernel;
  3. hold each kernel against its plain torch version on the card, bit for
     bit: the feasibility kernels at the solve's shapes, on ragged edges and
     on bounded/complement rows; uid_project on ragged type counts and U=1;
     the fused scan on the 27 operands of four small solves this script sets
     up (no nodes/limits; existing nodes with seeded usage; a second
     NodePool with a cpu limit; both at once with two templates), all 10
     outputs compared;
  4. the main path: the bench workload (kwok catalog x7 = 1008 types and
     8064 offerings, 50,000 pods from 200 shapes drawn with RandomState(7),
     one `default` NodePool, empty cluster) through the port's
     Scheduler.solve with a CUDA CatalogEngine and the fused scan left at
     `auto`, cold once and warm twice; launch counts are zeroed just before
     and read just after. Then the slice-1 path (scan off, the native walk)
     on the same workload, cold and warm, with the same decisions;
  5. decision identity on a 5,000-pod prefix: CUDA with the scan, CUDA with
     the walk and a device="cpu" engine (walk, plain versions); and the
     nodes-and-limits solve with the scan on CUDA against the plain scan on
     the CPU;
  6. one JSON line {"kernels": [...]}: per kernel its launches in phase 4,
     agreement with the plain version, and CUDA-event medians of the kernel,
     the plain version and a PyTorch yardstick on the inputs phase 4 gave it,
     beside its bound (the larger of bytes over the memory rate and
     operations over the rate for their type);
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
# float64 operations per second outside the tensor cores (H100 SXM data
# sheet: 34 TFLOP/s FP64), the rate of the fused scan's compares and
# subtractions
F64_OPS_PER_S = 34e12
NUM_PODS = 50_000
CATALOG_REPEAT = 7
PREFIX_PODS = 5_000
SMALL_PODS = 2_000
SOURCE = {
    "row_compat": "karpenter_tpu_torch/csrc/feasibility.cu",
    "membership": "karpenter_tpu_torch/csrc/feasibility.cu",
    "cube": "karpenter_tpu_torch/csrc/feasibility.cu",
    "uid_project": "karpenter_tpu_torch/csrc/feasibility.cu",
    "solve_scan": "karpenter_tpu_torch/csrc/scan.cu",
}
REPLACES = {
    "row_compat": "karpenter_tpu/ops/feasibility.py:48",
    "membership": "karpenter_tpu/ops/feasibility.py:177",
    "cube": "karpenter_tpu/ops/feasibility.py:265",
    "uid_project": "karpenter_tpu/ops/feasibility.py:332",
    "solve_scan": "karpenter_tpu/ops/packer.py:494",
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
    log(f"kernel checks: {n} feasibility and uid_project cases bit-identical to the plain versions")
    catalog = construct_instance_types()
    pods = build_pods()[:SMALL_PODS]
    for kind, want_cfg in (("plain", (1, False, False)), ("nodes", (1, True, False)),
                           ("limits", (2, False, True)), ("both", (2, True, True))):
        engine = CatalogEngine(catalog, device=dev)
        (cfg, args), _, _ = capture_scan(engine, catalog, pods, small_case(kind))
        assert tuple(cfg) == want_cfg, f"{kind}: scan variant {cfg}, expected {want_cfg}"
        got = packer.solve_scan(cfg, args)
        want = packer.solve_scan_plain(cfg, args)
        check_equal(f"solve_scan {kind}", tuple(got), tuple(want))
        pod_seq = want[4][: int(args[13])]
        log(f"solve_scan {kind} cfg={cfg}: {int(args[13])} pods, abort {int(want[0])}, "
            f"{int(want[1])} claims, {int((pod_seq >= 0).sum())} placed, "
            f"{int((want[3] >= 0).sum())} node joins: all 10 outputs bit-identical")


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
    # the kernels on them afterwards (recording does not launch anything)
    real = (feas.req_rows_vs_sets, feas.production_cube, feas.uid_project, packer.solve_scan)

    def keep(name, args, size):
        if name not in captured or size(args) >= size(captured[name]):
            captured[name] = args

    def rows_shim(*args):
        keep("row_compat", args, lambda a: a[6].shape[0])
        return real[0](*args)

    def cube_shim(*args):
        keep("cube", args, lambda a: a[0].numel())
        return real[1](*args)

    def uid_shim(*args):
        keep("uid_project", args, lambda a: a[1].numel())
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
    feas.req_rows_vs_sets, feas.production_cube, feas.uid_project, packer.solve_scan = (
        rows_shim, cube_shim, uid_shim, scan_shim)
    ffd._NativeDriver.drive = drive_shim
    try:
        solves0, fused0, declines0 = ffd.DEVICE_SOLVES, fused.FUSED_SOLVES, dict(fused.FUSED_DECLINES)
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        runs = []
        for label in ("cold", "warm", "warm"):
            before = _count_launches()
            results, ms = solve(engine, catalog, copy.deepcopy(pods))
            runs.append((label, ms, results,
                         {k: v - before[k] for k, v in _count_launches().items()}))
        launches = _count_launches()
        fused_solves = fused.FUSED_SOLVES - fused0
        declines = {k: v - declines0.get(k, 0) for k, v in fused.FUSED_DECLINES.items()
                    if v != declines0.get(k, 0)}
        scan_native = len(native_runs)
        # the slice-1 path: the walk, cold on a fresh engine and warm, with
        # its own launch counts (the recording shims are off: the timed
        # inputs stay the scan path's)
        feas.req_rows_vs_sets, feas.production_cube, feas.uid_project, packer.solve_scan = real
        fused.FUSED_MODE = "off"
        walk_engine = CatalogEngine(catalog, device=device)
        walk_runs = []
        feas.reset_launch_counts()
        packer.reset_launch_counts()
        for label, eng in (("cold", walk_engine), ("warm", walk_engine)):
            results, ms = solve(eng, catalog, copy.deepcopy(pods))
            walk_runs.append((label, ms, results))
        walk_launches = _count_launches()
    finally:
        fused.FUSED_MODE = mode0
        feas.req_rows_vs_sets, feas.production_cube, feas.uid_project, packer.solve_scan = real
        ffd._NativeDriver.drive = real_drive
    for label, ms, results, per_solve in runs:
        placed = sum(len(nc.pods) for nc in results.new_node_claims)
        log(f"solve {label} (scan): {ms:.1f} ms wall, {len(results.new_node_claims)} nodeclaims, "
            f"{placed} pods placed, {len(results.pod_errors)} pod errors, "
            f"launches {json.dumps(per_solve)}")
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
    for name in ("row_compat", "membership", "cube", "uid_project"):
        assert launches[name] > 0, f"{name} never launched on the main path"
    assert walk_launches["solve_scan"] == 0, "the scan launched on the walk path"
    for name in ("row_compat", "membership", "cube"):
        assert walk_launches[name] > 0, f"{name} never launched on the walk path"
    first = decisions(runs[0][2])
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


def timing_entries(rows, cube, launches, label):
    """The feasibility kernels on the given inputs: each must match its
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
        entries.append(_entry(
            name, launches, _max_abs_err(got, want), cuda_ms(kernel),
            cuda_ms(plain, reps=5, warmup=1), nbytes(*inputs) + nbytes(*gots), word_ops,
            WORD_OPS_PER_S, cuda_ms(library) if library is not None else None,
            _dev_sum(device_kernel_ms(kernel, device_names)),
            shapes=[list(t.shape) for t in inputs],
        ))

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


def scan_entries(uid_args, scan, prefix_scan, launches):
    """uid_project on the main path's famu_ok inputs (yardstick: the
    reference's f32 matmul form); solve_scan on the main path's operands
    (the wrapper's ms, the kernel's device ms, steps and us per step, the
    bound), checked and set against its plain version on the 5k prefix's
    operands (the plain loop at 50k pods would take minutes)."""
    from karpenter_tpu_torch.ops import feasibility as feas
    from karpenter_tpu_torch.ops import packer

    onehot, mask = uid_args
    got, want = feas.uid_project(onehot, mask), feas.uid_project_plain(onehot, mask)
    check_equal("uid_project on the main path's inputs", got, want)
    U, I = onehot.shape
    R = mask.numel() // I
    # word ops the function needs: one OR per 32-type word of each (row,
    # uid) pair, the count the feasibility entries use
    uid = _entry(
        "uid_project", launches, _max_abs_err(got, want),
        cuda_ms(lambda: feas.uid_project(onehot, mask)),
        cuda_ms(lambda: feas.uid_project_plain(onehot, mask), reps=5, warmup=1),
        nbytes(onehot, mask, got), R * U * ((I + 31) // 32), WORD_OPS_PER_S,
        cuda_ms(lambda: (mask.float() @ onehot.float().T) > 0.5),
        _dev_sum(device_kernel_ms(lambda: feas.uid_project(onehot, mask), ["uid_project_kernel"])),
        shapes=[list(onehot.shape), list(mask.shape)],
    )

    cfg, args = scan
    run = lambda: packer.solve_scan(cfg, args)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    n_pods = int(args[13])
    placed = int((out[4][:n_pods] >= 0).sum())
    assert placed == n_pods, f"solve_scan: {n_pods - placed} pods unplaced on the main path"
    steps = int(out[packer.SCAN_N_OUT])  # the kernel's own count of loop iterations
    assert steps >= n_pods, f"solve_scan: {steps} steps for {n_pods} placed pods"
    ms = cuda_ms(run, reps=1, warmup=1, rounds=3)
    dev_ms = _dev_sum(device_kernel_ms(run, ["solve_scan_kernel"], reps=2))
    G, D = args[2].shape
    U = args[4].shape[0]
    # float64 compares and subtractions per step: the refreshed cfit row
    # (G groups x U rows x D dims), the join's fit test and the committed
    # row (U x D each)
    f64_ops = steps * (G * U * D + 2 * U * D)
    pcfg, pargs = prefix_scan
    pgot, pwant = packer.solve_scan(pcfg, pargs), packer.solve_scan_plain(pcfg, pargs)
    check_equal("solve_scan on the prefix's operands", tuple(pgot), tuple(pwant))
    scan = _entry(
        "solve_scan", launches, _max_abs_err(tuple(pgot), tuple(pwant)), ms,
        cuda_ms(lambda: packer.solve_scan_plain(pcfg, pargs), reps=1, warmup=0, rounds=1),
        nbytes(*args) + nbytes(*out), f64_ops, F64_OPS_PER_S, None, dev_ms,
        steps=steps, us_per_step=(dev_ms * 1e3 / steps) if dev_ms else None,
        prefix_ms=cuda_ms(lambda: packer.solve_scan(pcfg, pargs), reps=1, warmup=1, rounds=3),
        prefix_pods=int(pargs[13]),
        shapes={"P": int(args[0].shape[0]), "G": G, "C": int(args[1].shape[0]), "U": U, "D": D,
                "F": int(args[10].shape[0]), "T": cfg[0], "nodes": cfg[1], "limits": cfg[2]},
    )
    return [uid, scan]


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
    log(f"phases 1-3 done at {time.perf_counter() - t_start:.1f} s")
    if not args.quick:
        captured: dict = {}
        launches = phase_main(captured)
        prefix_scan = phase_identity()
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
                               "bound_ms", "bound_by", "bytes", "ops", "shapes")}
            for e in wide]}))
        kernels = timing_entries(captured["row_compat"], captured["cube"], launches,
                                 "the main path's inputs")
        kernels += scan_entries(captured["uid_project"], captured["solve_scan"], prefix_scan,
                                launches)
        log(json.dumps({"kernels": kernels}))
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
