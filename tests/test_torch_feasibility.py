"""The port's feasibility functions against the JAX package's.

Inputs are made from a numpy seed and handed to both packages: the JAX
device programs run jitted on the CPU, the port's wrappers get CPU tensors
and so run their plain torch versions. Outputs are bool, so agreement is
exact. The kernels themselves run only on a card (test_torch_kernels.py).
Also here: the port's import rules, and that its entry points refuse to
start on the CPU unless asked.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import encoding as jenc
from karpenter_tpu.ops import feasibility as jfeas
from karpenter_tpu_torch.mesh import Mesh
from karpenter_tpu_torch.ops import encoding as tenc
from karpenter_tpu_torch.ops import feasibility as tfeas

import torch_inputs
from torch_inputs import cube_inputs, fits_inputs, onehot, row_inputs, stage_inputs, to_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(8)


def test_encoding_sentinels_match():
    assert (tenc.WORD, tenc.NO_GT, tenc.NO_LT, tenc.NOT_INT) == (
        jenc.WORD, jenc.NO_GT, jenc.NO_LT, jenc.NOT_INT,
    )
    assert (torch_inputs.NO_GT, torch_inputs.NO_LT, torch_inputs.NOT_INT) == (
        jenc.NO_GT, jenc.NO_LT, jenc.NOT_INT,
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_row_compat_matches_jax(seed):
    args = row_inputs(seed)
    want = np.asarray(jfeas.req_rows_vs_sets(*(jnp.asarray(a) for a in args)))
    got = tfeas.req_rows_vs_sets(*(to_torch(a) for a in args))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_membership_matches_jax(seed):
    membership, req_compat = cube_inputs(seed)[:2]
    want = np.asarray(jfeas.membership_all(jnp.asarray(membership), jnp.asarray(req_compat)))
    got = tfeas.membership_all(to_torch(membership), to_torch(req_compat))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_cube_matches_jax(seed):
    args = cube_inputs(seed)
    I = args[1].shape[1]
    jargs = [jnp.asarray(a) for a in args[:6]] + [jnp.asarray(onehot(args[6], I))]
    want_c, want_o = (np.asarray(x) for x in jfeas.production_cube(*jargs))
    got_c, got_o = tfeas.production_cube(*(to_torch(a) for a in args))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    np.testing.assert_array_equal(got_o.numpy(), want_o)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("seed", SEEDS)
def test_fits_matrix_matches_jax(seed, dtype):
    req, alloc = fits_inputs(seed, dtype)
    want = np.asarray(jfeas.fits_matrix(jnp.asarray(req), jnp.asarray(alloc)))
    got = tfeas.fits_matrix(to_torch(req), to_torch(alloc))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_fits_matrix_positive_request_against_zero_capacity():
    """resources.Fits: 1 against a zero capacity fails, 0 against it fits."""
    for dtype in (np.float32, np.int32):
        req = np.array([[1, 0], [0, 0], [0, 1]], dtype=dtype)
        alloc = np.array([[0, 4], [4, 0]], dtype=dtype)
        want = np.asarray(jfeas.fits_matrix(jnp.asarray(req), jnp.asarray(alloc)))
        got = tfeas.fits_matrix(to_torch(req), to_torch(alloc)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, [[False, True], [True, True], [True, False]])


@pytest.mark.parametrize("seed", SEEDS)
def test_stage_plane_matches_jax(seed):
    planes = stage_inputs(seed)
    want = np.asarray(jfeas.stage_plane(*(jnp.asarray(a) for a in planes)))
    got = tfeas.stage_plane(*(to_torch(a) for a in planes))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tfeas.stage_plane_np(*planes))


def test_unpack_mask_high_bit():
    """Bit 31 of a word survives the int32 view (arithmetic shift)."""
    words = np.array([[0x80000001, 0x00000002]], dtype=np.uint32)
    bits = tfeas.unpack_mask(to_torch(words)).numpy()
    want = np.asarray(jfeas.unpack_mask(jnp.asarray(words)))
    np.testing.assert_array_equal(bits, want)
    assert bits[0, 31] and bits[0, 0] and bits[0, 33] and bits.sum() == 3


def test_wrapper_refuses_other_devices():
    args = [to_torch(a).to("meta") for a in cube_inputs(0)[:2]]
    with pytest.raises(ValueError):
        tfeas.membership_all(*args)


def test_launch_counts_untouched_by_plain_versions():
    tfeas.reset_launch_counts()
    args = cube_inputs(3)
    tfeas.production_cube(*(to_torch(a) for a in args))
    tfeas.req_rows_vs_sets(*(to_torch(a) for a in row_inputs(3)))
    tfeas.uid_project(torch.ones((2, 5), dtype=torch.bool), torch.ones((3, 5), dtype=torch.bool))
    tfeas.offering_reduce(*(to_torch(a) for a in args[:1] + args[2:]), args[1].shape[1])
    tfeas.fits_matrix(torch.zeros((3, 4)), torch.ones((5, 4)))
    planes = torch.ones((3, 5), dtype=torch.bool)
    tfeas.stage_plane(planes, planes, planes)
    mesh = Mesh([torch.device("cpu")] * 2)
    cube = [to_torch(a) for a in args]
    cube[0] = torch.zeros((8, cube[0].shape[1]), dtype=torch.bool)
    cube[4] = torch.zeros((8, cube[4].shape[1]), dtype=torch.bool)
    tfeas.sharded_cube(mesh)(*cube)
    assert tfeas.LAUNCHES == {
        "row_compat": 0, "membership": 0, "cube": 0, "uid_project": 0, "offering_reduce": 0,
        "fits_matrix": 0, "stage_plane": 0, "sharded_cube": 0,
    }


# -- import rules --------------------------------------------------------------


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "karpenter_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 40
    bad = []
    for path in files:
        tree = ast.parse(open(path).read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "karpenter_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {name}")
    assert not bad, bad


def test_port_import_leaves_jax_unloaded():
    code = (
        "import sys, karpenter_tpu_torch\n"
        "import karpenter_tpu_torch.scheduler.scheduler, karpenter_tpu_torch.ops.ffd\n"
        "import karpenter_tpu_torch.ops.catalog, karpenter_tpu_torch.convert\n"
        "import karpenter_tpu_torch.cloudprovider.kwok.instance_types\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'karpenter_tpu')]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_engine_default_device_needs_cuda(monkeypatch):
    from karpenter_tpu_torch.cloudprovider.kwok.instance_types import construct_instance_types
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    catalog = construct_instance_types()[:4]
    with pytest.raises(RuntimeError, match="CUDA"):
        CatalogEngine(catalog, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        CatalogEngine(catalog, device="cuda")
    assert CatalogEngine(catalog, device="cpu").device.type == "cpu"
