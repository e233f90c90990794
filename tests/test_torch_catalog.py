"""The port's CatalogEngine against the JAX package's.

Both packages build the same catalog and the same requirement sets, each in
its own API, from one numpy-seeded spec: the kwok catalog, extended with an
integer label (so Gt/Lt rows reach the bounds path) and, on some offerings,
a custom key (so the undefined-label rule reaches the cube). The JAX engine
runs its device programs (FORCE_BACKEND="device", jitted on the CPU); the
port's engine runs with device="cpu", i.e. its plain torch versions. Every
result is bool or float64, so agreement is exact.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from karpenter_tpu.ops import catalog as jcatalog
from karpenter_tpu_torch.convert import engine_state_from_numpy

torch.set_num_threads(1)

CPU_KEY = "example.com/cpu-count"
POOL_KEY = "example.com/pool"
SEEDS = range(4)


def _mods(pkg: str):
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return m


def build_catalog(pkg: str, seed: int):
    m = _mods(pkg)
    types = m("cloudprovider.types")
    req = m("scheduling.requirements")
    rng = np.random.RandomState(seed)
    base = m("cloudprovider.kwok.instance_types").construct_instance_types()
    pick = rng.rand(len(base)) < 0.5
    out = []
    for i, it in enumerate(base[:: 2 + seed % 2]):
        reqs = req.Requirements(*it.requirements.values())
        cpu = str(int(it.capacity["cpu"]))
        reqs.add(req.Requirement(CPU_KEY, req.Operator.IN, [cpu]))
        offerings = []
        for j, o in enumerate(it.offerings):
            oreqs = req.Requirements(*o.requirements.values())
            if pick[i] and j % 3 == 0:
                oreqs.add(req.Requirement(POOL_KEY, req.Operator.IN, ["a"]))
            offerings.append(
                types.Offering(requirements=oreqs, price=o.price, available=bool(rng.rand() < 0.9))
            )
        out.append(
            types.InstanceType(
                name=it.name,
                requirements=reqs,
                offerings=types.Offerings(offerings),
                capacity=it.capacity,
                overhead=it.overhead,
            )
        )
    return out


def build_queries(pkg: str, seed: int, n: int = 24):
    m = _mods(pkg)
    req = m("scheduling.requirements")
    wk = m("apis.labels")
    O = req.Operator
    rng = np.random.RandomState(1000 + seed)
    zones = ["kwok-zone-1", "kwok-zone-2", "kwok-zone-3", "kwok-zone-4"]
    choices = [
        lambda: req.Requirement(wk.LABEL_ARCH, O.IN, [["amd64", "arm64"][rng.randint(2)]]),
        lambda: req.Requirement(wk.LABEL_TOPOLOGY_ZONE, O.IN, list(rng.choice(zones, 2, replace=False))),
        lambda: req.Requirement(wk.LABEL_TOPOLOGY_ZONE, O.NOT_IN, [zones[rng.randint(4)]]),
        lambda: req.Requirement(wk.CAPACITY_TYPE_LABEL_KEY, O.IN, ["spot"]),
        lambda: req.Requirement(wk.LABEL_OS, O.EXISTS),
        lambda: req.Requirement(CPU_KEY, O.GT, [str(rng.choice([1, 4, 16, 64]))]),
        lambda: req.Requirement(CPU_KEY, O.LT, [str(rng.choice([2, 8, 48, 200]))]),
        lambda: req.Requirement(POOL_KEY, O.IN, ["a"]),
        lambda: req.Requirement(POOL_KEY, O.DOES_NOT_EXIST),
        lambda: req.Requirement("example.com/team", O.NOT_IN, ["x"]),
    ]
    out = []
    for _ in range(n):
        k = rng.randint(0, 4)
        picks = rng.choice(len(choices), size=k, replace=False)
        reqs = req.Requirements()
        for c in picks:
            reqs.add(choices[c]())
        out.append(reqs)
    return out


@pytest.fixture
def device_backend(monkeypatch):
    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")


def engines(seed: int):
    from karpenter_tpu.ops.catalog import CatalogEngine as JEngine
    from karpenter_tpu_torch.ops.catalog import CatalogEngine as TEngine

    je = JEngine(build_catalog("karpenter_tpu", seed))
    te = TEngine(build_catalog("karpenter_tpu_torch", seed), device="cpu")
    jq = build_queries("karpenter_tpu", seed)
    tq = build_queries("karpenter_tpu_torch", seed)
    return je, te, jq, tq


@pytest.mark.parametrize("seed", SEEDS)
def test_rows_and_compat_matrices_match(device_backend, seed):
    je, te, jq, tq = engines(seed)
    jrows = [je.rows_for(q) for q in jq]
    trows = [te.rows_for(q) for q in tq]
    assert jrows == trows
    je._ensure_rows()
    te._ensure_rows()
    assert te.num_rows == je.num_rows
    np.testing.assert_array_equal(te._req_compat, je._req_compat)
    np.testing.assert_array_equal(te._offer_compat, je._offer_compat)
    np.testing.assert_array_equal(te._row_trivial, je._row_trivial)
    # the bounds path was exercised: some Gt/Lt row rejects some type
    bounded = [i for i, r in enumerate(te._rows) if r.greater_than is not None or r.less_than is not None]
    assert bounded and not te._req_compat[bounded].all()


@pytest.mark.parametrize("seed", SEEDS)
def test_feasibility_matches(device_backend, seed):
    je, te, jq, tq = engines(seed)
    rng = np.random.RandomState(2000 + seed)
    D = len(je.resource_dims)
    assert te.resource_dims == je.resource_dims
    requests = np.zeros((len(jq), D))
    requests[:, je.resource_dims["cpu"]] = rng.choice([0.1, 1.0, 7.5, 300.0], size=len(jq))
    jrows = [je.rows_for(q) for q in jq]
    trows = [te.rows_for(q) for q in tq]
    jf = je.feasibility(jrows, requests, je.key_presence(jq))
    tf = te.feasibility(trows, requests, te.key_presence(tq))
    for field in ("compat", "fits", "has_offering"):
        np.testing.assert_array_equal(getattr(tf, field), getattr(jf, field))
    assert tf.feasible.any() and not tf.feasible.all()
    # the per-set host path agrees with the batched sweep
    for p, (rows, q) in enumerate(zip(trows, tq)):
        c, o = te.masks_for_rows(rows, [r.key for r in q])
        np.testing.assert_array_equal(c, tf.compat[p])
        np.testing.assert_array_equal(o, tf.has_offering[p])


@pytest.mark.parametrize("seed", SEEDS)
def test_engine_state_carries_across(device_backend, seed):
    je, te, jq, tq = engines(seed)
    for q in jq:
        je.rows_for(q)
    for q in tq:
        te.rows_for(q)
    je._ensure_rows()
    jarrays = {
        "_req_compat": je._req_compat,
        "_offer_compat": je._offer_compat,
        "offering_custom_need": je.offering_custom_need,
        "offering_available": je.offering_available,
        "_owner_onehot": je._owner_onehot,
        "allocatable": je.allocatable,
        "slot_key": je._tables.slot_key,
        "value_int": je._tables.value_int,
    }
    from_jax = engine_state_from_numpy(jarrays, "cpu")
    from_port = engine_state_from_numpy(te.state_arrays(), "cpu")
    assert sorted(from_jax) == sorted(from_port)
    for name, t in from_port.items():
        assert t.dtype == from_jax[name].dtype, name
        assert torch.equal(t, from_jax[name]), name
    assert from_port["allocatable"].dtype == torch.float64
    assert from_port["offering_owner"].dtype == torch.int32


@pytest.mark.parametrize("seed", SEEDS)
def test_carried_state_feeds_both_cubes(device_backend, seed):
    """The JAX cube and the port's, fed the same converted catalog state and
    the same query membership, agree."""
    import jax.numpy as jnp

    from karpenter_tpu.ops import feasibility as jfeas
    from karpenter_tpu_torch.ops import feasibility as tfeas

    je, _te, jq, _tq = engines(seed)
    rows = [je.rows_for(q) for q in jq]
    je._ensure_rows()
    state = engine_state_from_numpy(
        {
            "req_compat": je._req_compat,
            "offer_compat": je._offer_compat,
            "offering_custom_need": je.offering_custom_need,
            "offering_available": je.offering_available,
            "owner_onehot": je._owner_onehot,
        },
        "cpu",
    )
    membership = np.zeros((len(rows), je.num_rows), dtype=bool)
    for p, rs in enumerate(rows):
        membership[p, rs] = True
    key_present = je.key_presence(jq)
    want = jfeas.production_cube(
        jnp.asarray(membership), jnp.asarray(je._req_compat), jnp.asarray(je._offer_compat),
        jnp.asarray(je.offering_custom_need), jnp.asarray(key_present),
        jnp.asarray(je.offering_available), jnp.asarray(je._owner_onehot),
    )
    got = tfeas.production_cube(
        torch.from_numpy(membership), state["req_compat"], state["offer_compat"],
        state["offering_custom_need"], torch.from_numpy(key_present),
        state["offering_available"], state["offering_owner"],
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_offerings_stored_owner_major():
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

    te = CatalogEngine(build_catalog("karpenter_tpu_torch", 0), device="cpu")
    assert np.all(np.diff(te.offering_owner) >= 0)
    assert te.offering_owner[-1] == te.num_instances - 1


def test_engine_state_rejects_malformed_arrays():
    with pytest.raises(KeyError):
        engine_state_from_numpy({"prices": np.zeros(3)}, "cpu")
    two_owners = np.array([[True, True], [False, True]])
    with pytest.raises(ValueError, match="one owner"):
        engine_state_from_numpy({"_owner_onehot": two_owners}, "cpu")
    with pytest.raises(ValueError, match="int32"):
        engine_state_from_numpy({"offering_owner": np.array([2**40])}, "cpu")
    words = np.array([0xFFFFFFFF], dtype=np.uint32)
    got = engine_state_from_numpy({"slot_key": words}, "cpu")["slot_key"]
    assert got.dtype == torch.int32 and int(got[0]) == -1  # same bits


@pytest.mark.parametrize("device", ["meta", "cpu:0"])
def test_resolve_device(device):
    from karpenter_tpu_torch.device import resolve_device

    if device == "meta":
        with pytest.raises(ValueError):
            resolve_device(device)
    else:
        assert resolve_device(device).type == "cpu"
