"""B6 in its factored form: the fused scan's famu_ok against the JAX package.

The port builds famu_ok ([T, F, U] bools: does any type of template t and
family f map onto unique-allocatable row u) with one call,
`feasibility.uid_project_factored(uid_onehot, tmpl_mask, fam_mask)`, where
the reference calls `uid_project(uid_onehot, tmpl_mask[:, None] &
fam_mask[None])` (karpenter_tpu/ops/fused.py). On CPU tensors the wrapper
runs its plain torch version, which chip_smoke.py and
tests/test_torch_kernels.py hold the kernel against on the card; here it is
held to the reference on numpy-seeded masks, and on the operands of whole
fused solves. Every comparison is exact: the outputs are bools.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from karpenter_tpu.ops import feasibility as jfeas  # noqa: E402
from karpenter_tpu_torch.ops import feasibility as tfeas  # noqa: E402
from karpenter_tpu_torch.ops import packer as tpacker  # noqa: E402
from test_torch_scan import _capture_jax_scans, _spec, fresh  # noqa: E402, F401
from test_torch_solve import solve  # noqa: E402
from torch_inputs import FAMU_F, FAMU_I, FAMU_T, FAMU_U, famu_inputs  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("I", FAMU_I)
@pytest.mark.parametrize("U", FAMU_U)
@pytest.mark.parametrize("F", FAMU_F)
@pytest.mark.parametrize("T", FAMU_T)
def test_uid_project_factored_plain_matches_jax(T, F, U, I):
    uid_of_type, tmpl, fam = famu_inputs(T, F, U, I)
    want = np.asarray(jfeas.uid_project(jnp.asarray(jfeas.uid_onehot_matrix(uid_of_type, U)),
                                        jnp.asarray(tmpl[:, None] & fam[None])))
    n0 = dict(tfeas.LAUNCHES)
    got = tfeas.uid_project_factored(torch.from_numpy(tfeas.uid_onehot_matrix(uid_of_type, U)),
                                     torch.from_numpy(tmpl), torch.from_numpy(fam))
    assert tfeas.LAUNCHES == n0  # the plain version launches nothing
    assert got.dtype == torch.bool and tuple(got.shape) == (T, F, U)
    np.testing.assert_array_equal(got.numpy(), want)
    if T > 1:
        assert not want[-1].any()  # the all-false template row
    if F > 1:
        assert not want[:, 0].any()  # the all-false family row


def test_uid_project_factored_plain_of_no_family():
    uid_of_type, tmpl, _ = famu_inputs(2, 1, 5, 31)
    onehot = torch.from_numpy(tfeas.uid_onehot_matrix(uid_of_type, 5))
    got = tfeas.uid_project_factored(onehot, torch.from_numpy(tmpl), torch.zeros((0, 31), dtype=torch.bool))
    assert got.dtype == torch.bool and tuple(got.shape) == (2, 0, 5)


@pytest.mark.parametrize("kind,seed", [("plain", 0), ("plain", 1), ("plain", 3), ("cluster", 0),
                                       ("cluster", 1)])
def test_fused_solve_builds_famu_ok_as_the_reference(fresh, monkeypatch, kind, seed):
    """A whole fused solve in each package (odd seeds: two templates and
    limits): the port's scan operands famu_ok (slot 12), fam_mask (17),
    tmpl_mask (18) and uid_onehot (20) equal the reference's, and famu_ok
    came from one uid_project_factored call."""
    seen = _capture_jax_scans(monkeypatch)
    s = _spec(kind, seed)
    solve("karpenter_tpu", s)
    assert len(seen) == 1, "the JAX solve did not run the fused scan"
    cfg, want, _ = seen[0]
    fresh()
    got, calls = [], []
    real_scan, real_famu = tpacker.solve_scan, tfeas.uid_project_factored

    def scan_shim(c, args):
        got.append((c, args))
        return real_scan(c, args)

    def famu_shim(*args):
        calls.append(args)
        return real_famu(*args)

    monkeypatch.setattr(tpacker, "solve_scan", scan_shim)
    monkeypatch.setattr(tfeas, "uid_project_factored", famu_shim)
    solve("karpenter_tpu_torch", s)
    assert len(got) == 1 and len(calls) == 1
    tcfg, targs = got[0]
    assert tuple(tcfg) == tuple(cfg)
    for slot in (12, 17, 18, 20):
        g = targs[slot].numpy()
        assert g.dtype == want[slot].dtype and g.shape == want[slot].shape, slot
        np.testing.assert_array_equal(g, want[slot])
    assert tuple(targs[12].shape) == (cfg[0], targs[17].shape[0], targs[20].shape[0])
