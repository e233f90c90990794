"""The port's CUDA kernels against their plain torch versions, on the card.

The kernels have no CPU mode, so every test here needs an NVIDIA card with
nvcc and skips without one. No jax: on the card, run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(tests/conftest.py pins jax to the CPU, and that machine has no jax).
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu_torch import convert  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from torch_inputs import cube_inputs, row_inputs, scan_inputs, to_torch, uid_inputs  # noqa: E402

SEEDS = range(8)


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
@pytest.mark.parametrize("seed", SEEDS)
def test_uid_project_matches_plain_on_card(cuda_device, seed):
    for lead in ((7,), (1,), (3, 5), (1, 64)):
        onehot, mask = (to_torch(a).to(cuda_device) for a in uid_inputs(seed, lead))
        assert torch.equal(tfeas.uid_project(onehot, mask), tfeas.uid_project_plain(onehot, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["plain", "nodes", "limits", "both"])
@pytest.mark.parametrize("seed", range(3))
def test_solve_scan_matches_plain_on_card(cuda_device, variant, seed):
    """All 10 outputs and the step count bit for bit (float64 compared
    as raw bits)."""
    cfg, args = scan_inputs(seed, variant in ("nodes", "both"), variant in ("limits", "both"))
    ops = convert.scan_operands_from_numpy(args, cuda_device)
    n0 = tpacker.LAUNCHES["solve_scan"]
    got = tpacker.solve_scan(cfg, ops)
    want = tpacker.solve_scan_plain(cfg, ops)
    torch.cuda.synchronize()
    assert tpacker.LAUNCHES["solve_scan"] == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w)
