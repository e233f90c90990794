"""The port's CUDA kernels against their plain torch versions, on the card.

The kernels have no CPU mode, so every test here needs an NVIDIA card with
nvcc and skips without one. No jax: on the card, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(tests/conftest.py pins jax to the CPU, and that machine has no jax).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu_torch import convert  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from karpenter_tpu_torch.device import KernelError  # noqa: E402
from karpenter_tpu_torch.mesh import Mesh  # noqa: E402
from torch_inputs import (  # noqa: E402
    FAMU_F, FAMU_I, FAMU_T, FAMU_U, GROUP_KERNEL_SHAPES, PASS_CASES, SCAN_EDGE_CASES,
    SWEEP_ROW_CASES, core_inputs, cube_inputs, famu_inputs, fits_inputs, frontier_inputs,
    group_inputs, group_kernel_inputs, mesh_kernel_inputs, offering_inputs, pass_inputs, row_inputs,
    scan_edge_inputs, scan_inputs, stage_inputs, sweep_inputs, target_inputs, to_torch, uid_inputs,
)

SEEDS = range(8)
# the scan kernel's two designs (csrc/scan.cu): the wrapper takes the
# resident one for every shape below whose set fits; "global" is forced
SCAN_DESIGNS = ["resident", "global"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_kernels_match_plain_on_card(cuda_device, seed):
    rows = [to_torch(a).to(cuda_device) for a in row_inputs(seed)]
    assert torch.equal(tfeas.req_rows_vs_sets(*rows), tfeas.req_rows_vs_sets_plain(*rows))
    cube = [to_torch(a).to(cuda_device) for a in cube_inputs(seed)]
    got = tfeas.production_cube(*cube)
    want = tfeas.production_cube_plain(*cube)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(
        tfeas.membership_all(cube[0], cube[1]), tfeas.membership_all_plain(cube[0], cube[1])
    )


@pytest.mark.cuda
@pytest.mark.parametrize("rows_case", SWEEP_ROW_CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_sweep_entries_match_plain_on_card(cuda_device, seed, rows_case):
    """B3 through cube_rows (kt_cube over resident rows read by index:
    sorted, with a repeat, none) and B1 through req_rows_vs_targets
    (kt_row_compat against one target and two), bit for bit; one launch a
    call and no kt_membership."""
    l0 = dict(tfeas.LAUNCHES)
    args = [to_torch(a).to(cuda_device) for a in sweep_inputs(seed, rows_case)]
    got = tfeas.cube_rows(*args)
    assert got.shape == (2, args[0].shape[0], args[3].shape[1])
    assert torch.equal(got, tfeas.cube_rows_plain(*args))
    # membership and key_present as column ranges of one array, as the
    # engine uploads them
    entities = torch.cat([args[0], args[1]], dim=1)
    Rm = args[0].shape[1]
    strided = [entities[:, :Rm], entities[:, Rm:]] + args[2:]
    assert torch.equal(tfeas.cube_rows(*strided), got)
    for targets in (1, 2):
        rows, sets, slot_key, value_int = target_inputs(seed, targets)
        table = to_torch(tfeas.row_table(*rows)).to(cuda_device)
        rows = [to_torch(a).to(cuda_device) for a in rows]
        sets = [[to_torch(a).to(cuda_device) for a in t] for t in sets]
        slot_key, value_int = to_torch(slot_key).to(cuda_device), to_torch(value_int).to(cuda_device)
        want = torch.cat([tfeas.req_rows_vs_sets_plain(*rows, *t, slot_key, value_int) for t in sets], 1)
        assert torch.equal(tfeas.req_rows_vs_targets(table, sets, slot_key, value_int), want)
    torch.cuda.synchronize()
    moved = {k: v - l0[k] for k, v in tfeas.LAUNCHES.items() if v != l0[k]}
    assert moved == {"cube": 2, "row_compat": 2}, moved


@pytest.mark.cuda
def test_sweep_packs_follow_their_sources_on_card(cuda_device):
    """The packed tables kt_cube and kt_row_compat read are made anew when a
    source changes in place (its _version moves): the next launch sees the
    change."""
    args = [to_torch(a).to(cuda_device) for a in sweep_inputs(2)]
    assert torch.equal(tfeas.cube_rows(*args), tfeas.cube_rows_plain(*args))
    args[5].logical_not_()  # custom_need
    assert torch.equal(tfeas.cube_rows(*args), tfeas.cube_rows_plain(*args))
    rows, sets, slot_key, value_int = target_inputs(3)
    table = to_torch(tfeas.row_table(*rows)).to(cuda_device)
    rows = [to_torch(a).to(cuda_device) for a in rows]
    sets = [[to_torch(a).to(cuda_device) for a in t] for t in sets]
    slot_key, value_int = to_torch(slot_key).to(cuda_device), to_torch(value_int).to(cuda_device)
    for change in (lambda: sets[0][0].logical_not_(), lambda: slot_key[::3].fill_(-1)):
        change()
        want = torch.cat([tfeas.req_rows_vs_sets_plain(*rows, *t, slot_key, value_int) for t in sets], 1)
        assert torch.equal(tfeas.req_rows_vs_targets(table, sets, slot_key, value_int), want)


@pytest.mark.cuda
def test_engine_row_batch_and_sweep_launch_once_on_card(cuda_device):
    """A CUDA CatalogEngine: one kt_row_compat launch a row batch (types and
    offerings together), one kt_cube launch a sweep and no kt_membership,
    with the planes of a device="cpu" engine."""
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.ops.catalog import CatalogEngine
    from karpenter_tpu_torch.scheduling.requirements import Operator, Requirement, Requirements

    catalog = construct_instance_types()
    queries = [
        Requirements(Requirement(wk.LABEL_ARCH, Operator.IN, ["arm64"])),
        Requirements(Requirement(wk.LABEL_TOPOLOGY_ZONE, Operator.NOT_IN, ["kwok-zone-1"]),
                     Requirement(wk.CAPACITY_TYPE_LABEL_KEY, Operator.IN, ["spot"])),
        Requirements(Requirement("example.com/team", Operator.IN, ["a"])),
        Requirements(),
    ]
    results = []
    for device in (cuda_device, "cpu"):
        engine = CatalogEngine(catalog, device=device)
        rows = [engine.rows_for(q) for q in queries]
        l0 = dict(tfeas.LAUNCHES)
        engine._ensure_rows()
        f = engine.feasibility(rows, np.zeros((len(rows), len(engine.resource_dims))),
                               engine.key_presence(queries))
        moved = {k: v - l0[k] for k, v in tfeas.LAUNCHES.items() if v != l0[k]}
        results.append((f.compat, f.has_offering, engine._req_compat, engine._offer_compat, moved))
    (cc, co, crc, coc, moved), (pc, po, prc, poc, _) = results
    assert moved == {"row_compat": 1, "cube": 1}, moved
    for got, want in ((cc, pc), (co, po), (crc, prc), (coc, poc)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_uid_project_matches_plain_on_card(cuda_device, seed):
    for lead in ((7,), (1,), (3, 5), (1, 64)):
        onehot, mask = (to_torch(a).to(cuda_device) for a in uid_inputs(seed, lead))
        assert torch.equal(tfeas.uid_project(onehot, mask), tfeas.uid_project_plain(onehot, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("I", FAMU_I)
@pytest.mark.parametrize("U", FAMU_U)
@pytest.mark.parametrize("T", FAMU_T)
def test_uid_project_factored_matches_plain_on_card(cuda_device, T, U, I):
    """famu_ok from the factored masks (one kt_uid_project launch a call,
    counted once) bit for bit against the plain product at every family
    count; the masks also as row ranges of one buffer (the fused solve's
    single upload) and at an odd byte offset (the kernel's byte path), and
    the generic uid_project of the product through the same kernel."""
    for F in FAMU_F:
        uid_of_type, tmpl, fam = famu_inputs(T, F, U, I)
        onehot = to_torch(tfeas.uid_onehot_matrix(uid_of_type, U)).to(cuda_device)
        tm, fm = to_torch(tmpl).to(cuda_device), to_torch(fam).to(cuda_device)
        want = tfeas.uid_project_factored_plain(onehot, tm, fm)
        n0 = tfeas.LAUNCHES["uid_project"]
        got = tfeas.uid_project_factored(onehot, tm, fm)
        torch.cuda.synchronize()
        assert tfeas.LAUNCHES["uid_project"] == n0 + 1
        assert got.dtype == torch.bool and torch.equal(got, want), F
        buf = torch.cat([onehot, fm, tm])
        views = buf[:U], buf[U + F:], buf[U:U + F]
        assert torch.equal(tfeas.uid_project_factored(*views), want)
        flat = torch.zeros(buf.numel() + 1, dtype=torch.bool, device=cuda_device)
        flat[1:] = buf.view(-1)
        odd = flat[1:].view(buf.shape)  # one byte past the buffer's 16-byte alignment
        assert torch.equal(tfeas.uid_project_factored(odd[:U], odd[U + F:], odd[U:U + F]), want)
        prod = (tm[:, None, :] & fm[None, :, :]).contiguous()
        assert torch.equal(tfeas.uid_project(onehot, prod), want)


def _force(design: str):
    """The wrapper's internal design argument: None (its own choice) for
    the resident design, which these shapes fit, "global" to force it."""
    return None if design == "resident" else design


@pytest.mark.cuda
@pytest.mark.parametrize("design", SCAN_DESIGNS)
@pytest.mark.parametrize("variant", ["plain", "nodes", "limits", "both"])
@pytest.mark.parametrize("seed", range(3))
def test_solve_scan_matches_plain_on_card(cuda_device, variant, seed, design):
    """All 10 outputs and the step count bit for bit (float64 compared
    as raw bits), in each design."""
    cfg, args = scan_inputs(seed, variant in ("nodes", "both"), variant in ("limits", "both"))
    ops = convert.scan_operands_from_numpy(args, cuda_device)
    assert tpacker.scan_design(cfg, ops) == "resident"
    n0, d0 = tpacker.LAUNCHES["solve_scan"], tpacker.LAUNCHES[f"scan_{design}"]
    got = tpacker.solve_scan(cfg, ops, _design=_force(design))
    want = tpacker.solve_scan_plain(cfg, ops)
    torch.cuda.synchronize()
    assert tpacker.LAUNCHES["solve_scan"] == n0 + 1
    assert tpacker.LAUNCHES[f"scan_{design}"] == d0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "nodes", "limits", "both"])
def test_solve_scan_past_the_budget_takes_the_global_design_on_card(cuda_device, variant):
    """scan_inputs(3): 16384 claim slots, past the resident set's shared
    memory, so the public entry point launches the global design; the
    outputs still equal the plain loop's."""
    cfg, args = scan_inputs(3, variant in ("nodes", "both"), variant in ("limits", "both"))
    ops = convert.scan_operands_from_numpy(args, cuda_device)
    assert tpacker.scan_design(cfg, ops) == "global"
    d0 = {k: tpacker.LAUNCHES[k] for k in ("scan_resident", "scan_global")}
    got = tpacker.solve_scan(cfg, ops)
    want = tpacker.solve_scan_plain(cfg, ops)
    torch.cuda.synchronize()
    assert {k: tpacker.LAUNCHES[k] - v for k, v in d0.items()} == {"scan_resident": 0, "scan_global": 1}
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("design", SCAN_DESIGNS)
@pytest.mark.parametrize("case", SCAN_EDGE_CASES)
def test_solve_scan_edges_match_plain_on_card(cuda_device, case, design):
    """The loop's edges (tests/torch_inputs.py scan_edge_inputs): a requeue
    when head + 1 == tail, the cycle stop, claim overflow, only KEY_MAX keys
    with claims open, and (resumed at Qcap - 4) queue overflow; the whole
    state bit for bit against the plain loop, in each design."""
    cfg, args, p_lo = scan_edge_inputs(case)
    ops = convert.scan_operands_from_numpy(args, cuda_device)
    if p_lo is None:
        got = tpacker.solve_scan_full(cfg, ops, _design=_force(design))
        want = tpacker.solve_scan_full_plain(cfg, ops)
    else:
        pre = list(args)
        pre[0] = args[0].copy()
        pre[0][p_lo:] = -1
        pre[13] = type(args[13])(p_lo)
        state = tpacker.solve_scan_full_plain(cfg, convert.scan_operands_from_numpy(pre, cuda_device))[:-1]
        state[0][0] = state[0][1] = state[1].shape[0] - (int(args[13]) - p_lo) - 1
        ref = tuple(t.clone() for t in state)
        got = tpacker.solve_scan_resume(cfg, ops, state, p_lo, _design=_force(design))
        want = tpacker.solve_scan_resume_plain(cfg, ops, ref, p_lo)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))


@pytest.mark.cuda
def test_scan_resident_bytes_match_the_kernel_on_card(cuda_device):
    """ops/packer.py's count of the resident set equals csrc/scan.cu's."""
    for seed in range(4):
        for nodes, limits in ((False, False), (True, True)):
            cfg, args = scan_inputs(seed, nodes, limits)
            d = tpacker._scan_dims(cfg, convert.scan_operands_from_numpy(args, "cpu"))
            assert tpacker.scan_resident_bytes(d) == tpacker.scan_resident_bytes_kernel(d), (seed, d)
    bench = {"C": 2048, "G": 128, "U": 36, "D": 4, "T": 1, "F": 64, "I": 1008, "limits": False}
    for C in (2048, 4096, 8192):
        d = {**bench, "C": C}
        assert tpacker.scan_resident_bytes(d) == tpacker.scan_resident_bytes_kernel(d)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int64) if t.dtype == torch.float64 else t


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_group_kernels_match_plain_on_card(cuda_device, seed):
    """B8 (kt_cube with no compat plane, as offering_reduce), B9/B10
    (kt_group_solve) and B11/B12 (kt_delta_scatter, kt_delta_finalize), bit
    for bit."""
    args, I = offering_inputs(seed)
    off = [to_torch(a).to(cuda_device) for a in args]
    assert torch.equal(tfeas.offering_reduce(*off, I), tfeas.offering_reduce_plain(*off, I))
    grp = [to_torch(a).to(cuda_device) for a in group_inputs(seed)]
    assert torch.equal(tpacker.solve_block(*grp), tpacker.solve_block_plain(*grp))
    assert torch.equal(tpacker.solve_block_core(*grp), tpacker.solve_block_core_plain(*grp))
    core, slots, rows, order, counts = (to_torch(a).to(cuda_device) for a in core_inputs(seed))
    got = tpacker.delta_scatter_rows(core.clone(), slots, rows)
    want = tpacker.delta_scatter_rows_plain(core.clone(), slots, rows)
    assert torch.equal(got, want)
    assert torch.equal(tpacker.delta_finalize(got, order, counts),
                       tpacker.delta_finalize_plain(want, order, counts))


@pytest.mark.cuda
@pytest.mark.parametrize("design", SCAN_DESIGNS)
@pytest.mark.parametrize("variant", ["plain", "nodes", "limits", "both"])
@pytest.mark.parametrize("seed", range(3))
def test_solve_scan_full_and_resume_match_plain_on_card(cuda_device, variant, seed, design):
    """B15 (kt_solve_scan, full mode) against the plain full solve, and B16
    (resume mode) from the plain state of a prefix against the plain
    resume: every state tensor and the step count bit for bit, in each
    design."""
    cfg, args = scan_inputs(seed, variant in ("nodes", "both"), variant in ("limits", "both"))
    ops = convert.scan_operands_from_numpy(args, cuda_device)
    n_pods = int(args[13])
    p_lo = n_pods * 2 // 3
    pre = list(args)
    pre[0] = args[0].copy()
    pre[0][p_lo:] = -1
    pre[13] = type(args[13])(p_lo)
    pre_ops = convert.scan_operands_from_numpy(pre, cuda_device)
    got = tpacker.solve_scan_full(cfg, ops, _design=_force(design))
    want = tpacker.solve_scan_full_plain(cfg, ops)
    state_k = tpacker.solve_scan_full(cfg, pre_ops, _design=_force(design))[:-1]
    state_p = tuple(t.clone() for t in state_k)
    res_k = tpacker.solve_scan_resume(cfg, ops, state_k, p_lo, _design=_force(design))
    res_p = tpacker.solve_scan_resume_plain(cfg, ops, state_p, p_lo)
    torch.cuda.synchronize()
    for g, w in list(zip(got, want)) + list(zip(res_k, res_p)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(_bits(g), _bits(w))
    assert all(a is b for a, b in zip(res_k[:-1], state_k))  # written in place


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_fits_matrix_and_stage_plane_match_plain_on_card(cuda_device, seed):
    """B4 (kt_fits_matrix, float32 and int32) and B7 (kt_stage_plane), bit
    for bit; an operand on another device raises."""
    n0 = dict(tfeas.LAUNCHES)
    for dtype in (np.float32, np.int32):
        req, alloc = (to_torch(a).to(cuda_device) for a in fits_inputs(seed, dtype))
        assert torch.equal(tfeas.fits_matrix(req, alloc), tfeas.fits_matrix_plain(req, alloc))
    planes = [to_torch(a).to(cuda_device) for a in stage_inputs(seed)]
    got = tfeas.stage_plane(*planes)
    assert got.dtype == torch.uint8 and torch.equal(got, tfeas.stage_plane_plain(*planes))
    torch.cuda.synchronize()
    assert tfeas.LAUNCHES["fits_matrix"] == n0["fits_matrix"] + 2
    assert tfeas.LAUNCHES["stage_plane"] == n0["stage_plane"] + 1
    with pytest.raises(KernelError):
        tfeas.fits_matrix(req, alloc.cpu())


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    return np.pad(a, ((0, -a.shape[0] % n),) + ((0, 0),) * (a.ndim - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_sharded_wrappers_match_unsharded_on_card(cuda_device, n, seed):
    """B5, B13 and B17 on a mesh that repeats the card n times against the
    unsharded launches: the cube and the group rows (entity axis padded to
    a multiple of n with rows that decide nothing), every replica of the
    classic, full and resume scans; exact launch counts per shard."""
    mesh = Mesh([cuda_device] * n)
    l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
    cube = list(cube_inputs(seed))
    P = cube[0].shape[0]
    cube[0], cube[4] = _pad_rows(cube[0], n), _pad_rows(cube[4], n)
    cube = [to_torch(a).to(cuda_device) for a in cube]
    got = tfeas.sharded_cube(mesh)(*cube)
    want = tfeas.production_cube(*cube)
    assert all(torch.equal(g[:P], w[:P]) for g, w in zip(got, want))
    grp = list(group_inputs(seed))
    G = grp[0].shape[0]
    grp[0], grp[1] = _pad_rows(grp[0], n), _pad_rows(grp[1], n)
    grp = [to_torch(a).to(cuda_device) for a in grp]
    assert torch.equal(tpacker.sharded_solve_block(mesh)(*grp)[:G], tpacker.solve_block(*grp)[:G])
    cfg, args = scan_inputs(seed, seed % 2 == 1, seed >= 2)
    ops = convert.scan_operands_from_numpy(args, cuda_device)
    classic = tpacker.sharded_solve_scan(mesh)(cfg, ops)
    want = tpacker.solve_scan(cfg, ops)
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(classic, want))
    full = tpacker.sharded_solve_scan_full(mesh)(cfg, ops)
    want = tpacker.solve_scan_full(cfg, ops)
    assert len(full) == n
    for rep in full:
        assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(rep, want))
    p_lo = int(args[13]) // 2
    pre = list(args)
    pre[0] = args[0].copy()
    pre[0][p_lo:] = -1
    pre[13] = type(args[13])(p_lo)
    pre_ops = convert.scan_operands_from_numpy(pre, cuda_device)
    states = [st[:-1] for st in tpacker.sharded_solve_scan_full(mesh)(cfg, pre_ops)]
    ref_state = tuple(t.clone() for t in states[0])
    res = tpacker.sharded_solve_scan_resume(mesh)(cfg, ops, states, p_lo)
    want = tpacker.solve_scan_resume(cfg, ops, ref_state, p_lo)
    for rep, st in zip(res, states):
        assert all(a is b for a, b in zip(rep[:-1], st))  # each replica in place
        assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(rep, want))
    torch.cuda.synchronize()
    moved = {k: v - l0[k] for k, v in {**tfeas.LAUNCHES, **tpacker.LAUNCHES}.items()}
    # one launch per card for the cube and the group solve, one per shard
    # for the replicated scans
    assert moved["sharded_cube"] == 1 and moved["sharded_solve_block"] == 1
    assert moved["sharded_solve_scan"] == n and moved["sharded_solve_scan_full"] == 2 * n
    assert moved["sharded_solve_scan_resume"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("entities", ["host", "card"])
@pytest.mark.parametrize("seed", range(4))
def test_fused_sharded_kernels_match_plain_on_card(cuda_device, n, entities, seed):
    """kt_cube_fused (B5) and kt_group_solve (B13) through sharded_cube and
    sharded_solve_block on a mesh repeating the card n times, against
    production_cube_plain and solve_block_plain bit for bit, on every row
    (padding included) at ragged shapes (tests/torch_inputs.py
    MESH_KERNEL_SHAPES): R and K past 32, I past one block, padding-only
    shards, a type without offerings and one whose offerings are never
    available, price ties. The entity operands come from the host (one
    staged upload) or lie on the card already (read in place); either way
    one launch per call on the one card, and none of the unsharded
    kernels."""
    mesh = Mesh([cuda_device] * n)
    _, cube, group = mesh_kernel_inputs(seed, n)
    cube_d = [to_torch(a).to(cuda_device) for a in cube]
    group_d = [to_torch(a).to(cuda_device) for a in group]
    if entities == "host":
        cube_in = [to_torch(cube[0])] + cube_d[1:4] + [to_torch(cube[4])] + cube_d[5:]
        group_in = [to_torch(group[0]), to_torch(group[1])] + group_d[2:]
    else:
        cube_in, group_in = cube_d, group_d
    l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
    got = tfeas.sharded_cube(mesh)(*cube_in)
    got_g = tpacker.sharded_solve_block(mesh)(*group_in)
    torch.cuda.synchronize()
    want = tfeas.production_cube_plain(*cube_d)
    assert all(g.device == mesh.devices[0] for g in got) and got_g.device == mesh.devices[0]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got_g, tpacker.solve_block_plain(*group_d))
    moved = {k: v - l0[k] for k, v in {**tfeas.LAUNCHES, **tpacker.LAUNCHES}.items() if v != l0[k]}
    assert moved == {"sharded_cube": 1, "sharded_solve_block": 1}


@pytest.mark.cuda
def test_fused_sharded_wrappers_refuse_bad_operands_on_card(cuda_device):
    """A breach of the sharded wrappers' contract raises KernelError before
    anything launches: entity operands on two devices, a wrong dtype, a
    catalog operand of the wrong shape, more shards on a card than one
    launch's slab table holds."""
    mesh = Mesh([cuda_device] * 2)
    _, cube, group = mesh_kernel_inputs(1, 2)
    cube_d = [to_torch(a).to(cuda_device) for a in cube]
    group_d = [to_torch(a).to(cuda_device) for a in group]
    l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
    bad_cube = (
        [to_torch(cube[0])] + cube_d[1:],  # membership on the host, key_present on the card
        [cube_d[0].int()] + cube_d[1:],
        cube_d[:2] + [cube_d[2][:, :-1]] + cube_d[3:],  # offer_compat one offering short
    )
    for args in bad_cube:
        with pytest.raises(KernelError):
            tfeas.sharded_cube(mesh)(*args)
    with pytest.raises(KernelError):
        tpacker.sharded_solve_block(mesh)(group_d[0], group_d[1].long(), *group_d[2:])
    wide = Mesh([cuda_device] * 72)  # 72 shards on one card: past the slab table's 64
    with pytest.raises(KernelError):
        tpacker.sharded_solve_block(wide)(
            torch.zeros((72, group[0].shape[1]), dtype=torch.bool),
            torch.zeros((72, group[1].shape[1]), dtype=torch.int32), *group_d[2:])
    assert {**tfeas.LAUNCHES, **tpacker.LAUNCHES} == l0


def _group_launches(before: dict) -> dict:
    return {k: v - before[k] for k, v in {**tfeas.LAUNCHES, **tpacker.LAUNCHES}.items() if v != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(len(GROUP_KERNEL_SHAPES)))
def test_group_solve_modes_match_plain_on_card(cuda_device, seed):
    """kt_group_solve's three modes, bit for bit against the plain
    versions, at ragged shapes (tests/torch_inputs.py GROUP_KERNEL_SHAPES:
    R past 2048, K past 2048, K=0, I past a block; group 0 all-infeasible,
    price ties): solve_block (B9, finalize), solve_block_core (B10, core)
    and solve_block_scatter (the frontier: edge-padded duplicate, negative
    and dropped slots, core written in place); exactly one launch a call,
    counted under its own name, and nothing else launched; then again on
    the same catalog, its packed words reused, and after an in-place change
    to a catalog plane, which the next call packs anew."""
    args = group_kernel_inputs(seed)
    grp = [to_torch(a).to(cuda_device) for a in args]
    core, slots, fargs = frontier_inputs(args, seed)
    fgrp = [to_torch(a).to(cuda_device) for a in fargs]
    core_d, slots_d = to_torch(core).to(cuda_device), to_torch(slots).to(cuda_device)
    want_core = tpacker.solve_block_scatter_plain(core_d.clone(), slots_d, *fgrp)
    for name, run, want in (
        ("solve_block", lambda: tpacker.solve_block(*grp), tpacker.solve_block_plain(*grp)),
        ("solve_block_core", lambda: tpacker.solve_block_core(*grp), tpacker.solve_block_core_plain(*grp)),
        ("solve_block_scatter", lambda: tpacker.solve_block_scatter(core_d, slots_d, *fgrp), want_core),
    ):
        l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
        got = run()
        torch.cuda.synchronize()
        assert _group_launches(l0) == {name: 1}, name
        assert got.dtype == want.dtype and torch.equal(got, want), name
    assert torch.equal(core_d, want_core)  # written in place
    # the path's way: solved again on the same catalog, its words reused
    packed = tpacker._packed(grp[2], grp[3], grp[4], grp[6])
    l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
    assert torch.equal(tpacker.solve_block(*grp), tpacker.solve_block_plain(*grp))
    assert torch.equal(tpacker.solve_block_core(*grp), tpacker.solve_block_core_plain(*grp))
    again = to_torch(core).to(cuda_device)
    tpacker.solve_block_scatter(again, slots_d, *fgrp)
    assert torch.equal(again, want_core)
    assert _group_launches(l0) == {"solve_block": 1, "solve_block_core": 1, "solve_block_scatter": 1}
    assert tpacker._packed(grp[2], grp[3], grp[4], grp[6]) is packed
    # a catalog plane changed in place: the next solve packs it anew
    grp[2][:, 0] = ~grp[2][:, 0]
    grp[3][:, 0] = ~grp[3][:, 0]
    assert torch.equal(tpacker.solve_block(*grp), tpacker.solve_block_plain(*grp))
    assert tpacker._packed(grp[2], grp[3], grp[4], grp[6]) is not packed


@pytest.mark.cuda
def test_group_wrappers_work_on_the_current_stream_on_card(cuda_device):
    """The lean launch reads the current stream every call: with the
    default stream held busy, B9 (solve_block), the frontier scatter and
    B11 (delta_scatter_rows) launched under another torch.cuda.Stream
    finish on that stream and equal the plain versions, while the default
    stream still sleeps."""
    args = group_kernel_inputs(3)
    grp = [to_torch(a).to(cuda_device) for a in args]
    core, slots, fargs = frontier_inputs(args, 3)
    fgrp = [to_torch(a).to(cuda_device) for a in fargs]
    core_d, slots_d = to_torch(core).to(cuda_device), to_torch(slots).to(cuda_device)
    rows = tpacker.solve_block_core_plain(*fgrp)
    want = (tpacker.solve_block_plain(*grp).cpu(),
            tpacker.solve_block_scatter_plain(core_d.clone(), slots_d, *fgrp).cpu(),
            tpacker.delta_scatter_rows_plain(core_d.clone(), slots_d, rows).cpu())
    # warm: build and load the kernels before the clock starts
    tpacker.solve_block(*grp)
    tpacker.delta_scatter_rows(core_d.clone(), slots_d, rows)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=cuda_device)
    torch.cuda._sleep(1_000_000_000)  # ~0.5 s on the default stream
    with torch.cuda.stream(side):
        got = (tpacker.solve_block(*grp).cpu(),
               tpacker.solve_block_scatter(core_d.clone(), slots_d, *fgrp).cpu(),
               tpacker.delta_scatter_rows(core_d.clone(), slots_d, rows).cpu())
    busy = not torch.cuda.default_stream(cuda_device).query()
    torch.cuda.synchronize()
    assert busy, "the side stream's work waited for the default stream"
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_group_wrappers_refuse_bad_operands_on_card(cuda_device):
    """A breach of kt_group_solve's or kt_delta_scatter's contract raises
    KernelError before anything launches: a wrong dtype or width of the
    group rows, a catalog operand on the host, a scatter's slots of the
    wrong length or dtype, a core matrix of the wrong width, a stamp
    buffer of the wrong size, and rows past the kernel's shared memory."""
    args = group_kernel_inputs(3)
    grp = [to_torch(a).to(cuda_device) for a in args]
    core, slots, fargs = frontier_inputs(args, 3)
    fgrp = [to_torch(a).to(cuda_device) for a in fargs]
    core_d, slots_d = to_torch(core).to(cuda_device), to_torch(slots).to(cuda_device)
    rows = tpacker.solve_block_core_plain(*fgrp)
    l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
    bad = (
        lambda: tpacker.solve_block(grp[0], grp[1].long(), *grp[2:]),
        lambda: tpacker.solve_block_core(grp[0][:, :-1], *grp[1:]),
        lambda: tpacker.solve_block(*grp[:4], grp[4].cpu(), *grp[5:]),
        lambda: tpacker.solve_block_scatter(core_d, slots_d[:-1], *fgrp),
        lambda: tpacker.solve_block_scatter(core_d, slots_d.long(), *fgrp),
        lambda: tpacker.solve_block_scatter(core_d[:, :2].contiguous(), slots_d, *fgrp),
        lambda: tpacker._group_solve("solve_block", "finalize", grp[0], grp[1], grp[2:],
                                     stamps=torch.zeros(3, dtype=torch.int64, device=cuda_device)),
        lambda: tpacker.delta_scatter_rows(core_d, slots_d.long(), rows),
        lambda: tpacker.delta_scatter_rows(core_d, slots_d, rows[:, :2].contiguous()),
    )
    for k, call in enumerate(bad):
        with pytest.raises(KernelError):
            call()
    R = 2**21  # 65,536 row words: past 227 KB of shared memory
    wide = (torch.zeros((1, R), dtype=torch.bool, device=cuda_device),
            torch.zeros((1, 5), dtype=torch.int32, device=cuda_device),
            torch.ones((R, 1), dtype=torch.bool, device=cuda_device),
            torch.ones((R, 1), dtype=torch.bool, device=cuda_device),
            torch.zeros((1, 0), dtype=torch.bool, device=cuda_device),
            torch.ones(1, dtype=torch.bool, device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device),
            torch.ones((1, 4), dtype=torch.int32, device=cuda_device),
            torch.ones(1, dtype=torch.float32, device=cuda_device))
    with pytest.raises(KernelError):
        tpacker.solve_block(*wide)
    assert {**tfeas.LAUNCHES, **tpacker.LAUNCHES} == l0


@pytest.mark.cuda
@pytest.mark.parametrize("case", PASS_CASES)
@pytest.mark.parametrize("seed", range(4))
def test_delta_pass_matches_plain_on_card(cuda_device, case, seed):
    """A delta pass with a frontier (kt_group_solve's pass mode: the
    scatter, then the finalize in the launch's last block) bit for bit
    against solve_block_scatter_plain then delta_finalize_plain, the core
    written in place; one launch, counted under delta_pass alone; and at
    the wide shapes of the group kernels."""
    core, slots, gb, gi, order, counts, *cat = (to_torch(a).to(cuda_device)
                                                  for a in pass_inputs(case, seed))
    want_core = core.clone()
    want = tpacker.delta_pass_plain(want_core, slots, gb, gi, order, counts, *cat)
    l0 = {**tfeas.LAUNCHES, **tpacker.LAUNCHES}
    counter = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = tpacker.delta_pass(core, slots, gb, gi, order, counts, *cat, counter=counter)
    torch.cuda.synchronize()
    assert _group_launches(l0) == {"delta_pass": 1}
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(core, want_core)
    assert int(counter) == gb.shape[0]  # every block counted itself once
    args = group_kernel_inputs(seed)
    fcore, fslots, fargs = frontier_inputs(args, seed)
    fgrp = [to_torch(a).to(cuda_device) for a in fargs]
    fcore_d, fslots_d = to_torch(fcore).to(cuda_device), to_torch(fslots).to(cuda_device)
    cap = fcore.shape[0]
    order_d = to_torch(np.random.RandomState(seed).randint(0, cap, size=64).astype(np.int32)).to(cuda_device)
    counts_d = to_torch(np.random.RandomState(seed).randint(0, 900, size=64).astype(np.int32)).to(cuda_device)
    want_core = fcore_d.clone()
    want = tpacker.delta_pass_plain(want_core, fslots_d, *fgrp[:2], order_d, counts_d, *fgrp[2:])
    got = tpacker.delta_pass(fcore_d, fslots_d, *fgrp[:2], order_d, counts_d, *fgrp[2:])
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(fcore_d, want_core)


@pytest.mark.cuda
def test_delta_pass_counter_resets_on_card(cuda_device):
    """Passes back to back on one counter, queued without a synchronize,
    the counter left stale by hand before the first: the C entry zeroes it
    on the stream before each launch, so each pass's last block is found
    and each result equals the plain one; a frontier with no row and more
    than one slab are refused."""
    core, slots, gb, gi, order, counts, *cat = (to_torch(a).to(cuda_device)
                                                  for a in pass_inputs("edge_padded", 2))
    want_core = core.clone()
    first = tpacker.delta_pass_plain(want_core, slots, gb, gi, order, counts, *cat)
    counts2 = counts.flip(0).contiguous()
    second = tpacker.delta_finalize_plain(want_core, order, counts2)
    counter = torch.full((1,), 12345, dtype=torch.int32, device=cuda_device)
    got1 = tpacker.delta_pass(core, slots, gb, gi, order, counts, *cat, counter=counter)
    got2 = tpacker.delta_pass(core, slots, gb, gi, order, counts2, *cat, counter=counter)
    torch.cuda.synchronize()
    assert torch.equal(got1, first) and torch.equal(got2, second) and torch.equal(core, want_core)
    with pytest.raises(KernelError):
        tpacker.delta_pass(core, slots[:0], gb[:0], gi[:0], order, counts, *cat, counter=counter)
    with pytest.raises(KernelError):
        tpacker.delta_pass(core, slots, gb, gi, order, counts, *cat, counter=counter.long())


# -- the kernel observatory on the card (tracing/kernel.py, observability/kernels.py)


@pytest.mark.cuda
def test_dispatch_fences_on_a_cuda_event_on_card(cuda_device):
    """Inside measure() a named dispatch of a kernel waits for it on an
    event: block wall > 0, the output complete when dispatch returns; the
    registry records it fenced, with no compile once the kernels are
    built; without a context nothing fences."""
    from karpenter_tpu_torch.observability import kernels as kobs
    from karpenter_tpu_torch.tracing import kernel as ktime

    cube = [to_torch(a).to(cuda_device) for a in cube_inputs(0)]
    tfeas.production_cube(*cube)  # the build, if this process has not built yet
    torch.cuda.synchronize()
    reg = kobs.registry()
    reg.reset()
    try:
        with reg.batch_scope("card") as batch, ktime.measure() as acc:
            got = ktime.dispatch(tfeas.production_cube, *cube, kernel="feasibility.cube")
            done = torch.cuda.current_stream().query()
        assert done, "the dispatch returned before its kernel finished"
        assert acc["dispatches"] == 1 and acc["compiles"] == 0 and acc["block_s"] > 0
        assert batch["fenced"] == 1 and batch["device_busy_s"] > 0
        want = tfeas.production_cube_plain(*cube)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ktime.dispatch(tfeas.production_cube, *cube, kernel="feasibility.cube")  # unfenced
        snap = reg.debug_snapshot("feasibility.cube")
        assert snap["dispatches"] == 2 and snap["compiles"] == 0
    finally:
        reg.reset()


@pytest.mark.cuda
def test_build_counter_counts_libraries_on_card(cuda_device):
    """device.build_count() grows by the libraries a build loads, once:
    a second build_kernels() in the process loads nothing."""
    from karpenter_tpu_torch import device

    device.build_kernels()
    n = device.build_count()
    assert n >= len(device._sources())
    device.build_kernels()
    assert device.build_count() == n


@pytest.mark.cuda
def test_sample_device_memory_matches_the_allocator_on_card(cuda_device):
    from karpenter_tpu_torch.observability import kernels as kobs

    keep = torch.ones(1 << 20, device=cuda_device)  # noqa: F841 — held live
    torch.cuda.synchronize()
    sample = kobs.sample_device_memory()
    stats = torch.cuda.memory_stats(cuda_device)
    allocated = sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))
    assert sample["live_array_bytes"] == allocated >= 4 << 20
    dev = next(d for d in sample["devices"] if d["device"] == str(torch.device("cuda", cuda_device.index or 0)))
    assert dev["bytes_in_use"] == stats["allocated_bytes.all.current"]
    assert dev["peak_bytes_in_use"] == stats["allocated_bytes.all.peak"]
    assert dev["bytes_limit"] == torch.cuda.mem_get_info(cuda_device)[1]
    assert sample["live_arrays"] >= 1
    assert kobs.registry().debug_snapshot()["device_memory"] == sample
