"""The catalog sweep's entries of the port — the indexed cube (cube_rows,
B3) and the row batch against both targets (req_rows_vs_targets, B1) —
against the JAX package, and the packed tables their kernels read.

Inputs are made from a numpy seed and handed to both packages; the port's
entries get CPU tensors and so run their plain versions, which go through
the same packs the kernels read (req_rows_vs_targets unpacks them). Every
output is bool, so agreement is exact. The kernels themselves run only on
a card (test_torch_kernels.py).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.ops import feasibility as jfeas
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.ops import feasibility as tfeas

from torch_inputs import (
    SWEEP_ROW_CASES, cube_inputs, onehot, row_inputs, sweep_inputs, target_inputs, to_torch,
)

torch.set_num_threads(1)

SEEDS = range(8)


def _jax_cube(membership, key_present, rows, req_all, offer_all, custom_need, available, owner):
    """The JAX package's production_cube on the rows the index picks."""
    R = rows.shape[0]
    I = req_all.shape[1]
    args = (membership[:, :R], req_all[rows], offer_all[rows], custom_need, key_present, available,
            onehot(owner, I))
    return [np.asarray(x) for x in jfeas.production_cube(*(jnp.asarray(a) for a in args))]


@pytest.mark.parametrize("rows_case", SWEEP_ROW_CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_cube_rows_matches_jax(seed, rows_case):
    """cube_rows over resident rows picked by index (sorted, with a repeat,
    or none: R = 0 with its padding column) equals the JAX cube on the
    gathered rows; membership's padding columns decide nothing."""
    args = sweep_inputs(seed, rows_case)
    want_c, want_o = _jax_cube(*args)
    got = tfeas.cube_rows(*(to_torch(a) for a in args))
    assert got.dtype == torch.bool and got.shape == (2,) + want_c.shape
    np.testing.assert_array_equal(got[0].numpy(), want_c)
    np.testing.assert_array_equal(got[1].numpy(), want_o)


@pytest.mark.parametrize("targets", [1, 2])
@pytest.mark.parametrize("seed", SEEDS)
def test_row_targets_match_jax(seed, targets):
    """req_rows_vs_targets, through its packed tables, equals the JAX
    req_rows_vs_sets of each target side by side: bounded, complement and
    exempt rows and sets among them."""
    rows, sets, slot_key, value_int = target_inputs(seed, targets)
    want = np.concatenate(
        [np.asarray(jfeas.req_rows_vs_sets(*(jnp.asarray(a) for a in rows + tuple(s) + (slot_key, value_int))))
         for s in sets], axis=1)
    got = tfeas.req_rows_vs_targets(
        to_torch(tfeas.row_table(*rows)), [[to_torch(a) for a in s] for s in sets],
        to_torch(slot_key), to_torch(value_int))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)


def test_target_inputs_cover_every_kind_of_row():
    """Over the seeds, the row batches hold exempt rows (NotIn/DoesNotExist
    shaped: complement with values, or neither), complement rows with
    values to intersect, bounded rows, and sets of each kind."""
    from torch_inputs import NO_GT, NO_LT

    kinds = set()
    for seed in SEEDS:
        rows, sets, _, _ = target_inputs(seed)
        key, comp, hasv, gt, lt = rows[:5]
        kinds |= {"exempt"} if ((comp & hasv) | (~comp & ~hasv)).any() else set()
        kinds |= {"complement"} if comp.any() else set()
        kinds |= {"bounded"} if ((gt != NO_GT) | (lt != NO_LT)).any() else set()
        for present, scomp, shasv, sgt, slt, _ in sets:
            kinds |= {"set complement"} if (present & scomp).any() else set()
            kinds |= {"set bounded"} if (present & ((sgt != NO_GT) | (slt != NO_LT))).any() else set()
    assert kinds == {"exempt", "complement", "bounded", "set complement", "set bounded"}


@pytest.mark.parametrize("seed", SEEDS)
def test_packs_round_trip(seed):
    """row_table / row_fields (built on the host and on tensors alike),
    pack_sets / unpack_sets, key_slot_words / slot_key_of and pack_words /
    unpack_mask are inverses on the row kernel's inputs."""
    args = row_inputs(seed)
    table = tfeas.row_table(*args[:6])
    assert table.dtype == np.int32 and table.shape == (args[0].shape[0], tfeas.ROW_FIELDS + args[5].shape[1])
    assert torch.equal(tfeas.row_table(*(to_torch(a) for a in args[:6])), to_torch(table))
    for got, want in zip(tfeas.row_fields(to_torch(table)), args[:6]):
        assert torch.equal(got, to_torch(want))
    sets = [to_torch(a) for a in args[6:12]]
    packed = tfeas.pack_sets(*sets)
    N, K = sets[0].shape
    W = sets[5].shape[1]
    assert packed.flags.shape == packed.gt.shape == packed.lt.shape == (K, N)
    assert packed.mask.shape == (W, N) and packed.flags.is_contiguous()
    for got, want in zip(tfeas.unpack_sets(packed), sets):
        assert torch.equal(got, want)
    slot_key = to_torch(args[12])
    words = tfeas.key_slot_words(slot_key, K)
    assert words.shape == (K, W) and torch.equal(tfeas.slot_key_of(words), slot_key)
    mask = to_torch(args[5])
    assert torch.equal(tfeas.pack_words(tfeas.unpack_mask(mask)), mask)


def test_packs_follow_in_place_changes():
    """A source changed in place (its _version moves) packs anew: the next
    call sees the change, as the plain versions on the changed inputs."""
    rows, sets, slot_key, value_int = target_inputs(3)
    table = to_torch(tfeas.row_table(*rows))
    rows = [to_torch(a) for a in rows]
    sets = [[to_torch(a).clone() for a in s] for s in sets]
    slot_key, value_int = to_torch(slot_key).clone(), to_torch(value_int)

    def plain():
        return torch.cat([tfeas.req_rows_vs_sets_plain(*rows, *s, slot_key, value_int) for s in sets], 1)

    assert torch.equal(tfeas.req_rows_vs_targets(table, sets, slot_key, value_int), plain())
    sets[0][0].logical_not_()  # present
    sets[1][5].bitwise_not_()  # mask words
    slot_key[::3] = -1
    got = tfeas.req_rows_vs_targets(table, sets, slot_key, value_int)
    assert torch.equal(got, plain())


# owner layouts: 8 offerings a type (the workload's); ragged with empty
# types; one type past a block's offerings; no offerings at all
PLAN_OWNERS = {
    "uniform": lambda rng: np.repeat(np.arange(1008), 8),
    "ragged": lambda rng: np.sort(rng.randint(0, 300, size=2000)),
    "wide_type": lambda rng: np.sort(np.concatenate([rng.randint(0, 40, size=100), np.full(700, 17)])),
    "none": lambda rng: np.zeros(0, dtype=np.int64),
}


@pytest.mark.parametrize("layout", sorted(PLAN_OWNERS))
def test_cube_pack_and_block_plan(layout):
    """kt_cube's packed catalog: type_start bounds each type's offerings,
    the need words unpack to custom_need, and the block plan covers every
    type once, in order, in runs of at most a block's types and, unless
    one type alone has more, a block's offerings."""
    rng = np.random.RandomState(7)
    owner = PLAN_OWNERS[layout](rng).astype(np.int32)
    I = int(owner.max()) + 3 if owner.size else 5
    O, K = owner.shape[0], 40
    custom_need = to_torch(rng.rand(O, K) < 0.1)
    pack = tfeas.cube_pack(custom_need, to_torch(owner), I)
    starts = pack.type_start.numpy()
    np.testing.assert_array_equal(np.diff(starts), np.bincount(owner, minlength=I))
    assert starts[0] == 0 and starts[-1] == O
    assert torch.equal(tfeas.unpack_mask(pack.need_words.T.contiguous())[:, :K], custom_need)
    plan = pack.plan.numpy()
    assert plan[0] == 0 and plan[-1] == I and pack.runs == plan.shape[0] - 1
    per = tfeas._CUBE_THREADS
    for t0, t1 in zip(plan[:-1], plan[1:]):
        assert 0 < t1 - t0 <= per
        assert starts[t1] - starts[t0] <= per or t1 - t0 == 1


def test_cube_pack_refuses_unordered_offerings():
    owner = to_torch(np.array([0, 2, 1], dtype=np.int32))
    with pytest.raises(KernelError, match="owner-major"):
        tfeas.cube_pack(torch.zeros((3, 8), dtype=torch.bool), owner, 3)


def test_sweep_entries_launch_nothing_on_the_cpu():
    tfeas.reset_launch_counts()
    tfeas.cube_rows(*(to_torch(a) for a in sweep_inputs(1)))
    rows, sets, slot_key, value_int = target_inputs(1)
    tfeas.req_rows_vs_targets(to_torch(tfeas.row_table(*rows)), [[to_torch(a) for a in s] for s in sets],
                              to_torch(slot_key), to_torch(value_int))
    cube = [to_torch(a) for a in cube_inputs(1)]
    tfeas.production_cube(*cube)
    assert not any(tfeas.LAUNCHES.values())


# -- the engine: a sweep and a row batch after the vocabulary grows -----------


def _growth_queries(pkg: str, growth: str):
    """Queries that grow the vocabulary: "reencode" interns 10 new keys of
    10 values each (past the key and word capacities, so the catalog is
    encoded anew); "tables" a new value of a key the catalog knows (the
    slot tables change, the capacities do not)."""
    import importlib

    req = importlib.import_module(f"{pkg}.scheduling.requirements")
    O = req.Operator
    if growth == "reencode":
        return [req.Requirements(req.Requirement(f"example.com/grown-{k}", O.IN,
                                                 [f"v{j}" for j in range(10)]))
                for k in range(10)]
    from test_torch_catalog import CPU_KEY

    return [req.Requirements(req.Requirement(CPU_KEY, O.NOT_IN, ["12345"])),
            req.Requirements(req.Requirement(CPU_KEY, O.IN, ["12345", "4"]))]


@pytest.mark.parametrize("growth", ["reencode", "tables"])
@pytest.mark.parametrize("seed", range(3))
def test_engine_after_vocabulary_growth_matches_jax(monkeypatch, seed, growth):
    """A CPU CatalogEngine's row batch and sweep equal the JAX package's
    engine (device programs) before and after the vocabulary grows: the
    packs follow the re-encoded catalog and the new slot tables."""
    from karpenter_tpu.ops import catalog as jcatalog
    from test_torch_catalog import engines

    monkeypatch.setattr(jcatalog, "FORCE_BACKEND", "device")
    monkeypatch.setattr("karpenter_tpu_torch.ops.catalog.FORCE_BACKEND", "device")
    je, te, jq, tq = engines(seed)
    jq, tq = jq[:8], tq[:8]
    for q in jq:
        je.rows_for(q)
    for q in tq:
        te.rows_for(q)
    je._ensure_rows()
    te._ensure_rows()
    caps = (te._key_capacity, te._word_capacity, te._tables_version)
    inst_sets = te._inst_sets
    jq += _growth_queries("karpenter_tpu", growth)
    tq += _growth_queries("karpenter_tpu_torch", growth)
    jrows = [je.rows_for(q) for q in jq]
    trows = [te.rows_for(q) for q in tq]
    assert jrows == trows
    je._ensure_rows()
    te._ensure_rows()
    if growth == "reencode":
        assert te._key_capacity > caps[0] and te._word_capacity > caps[1]
        assert te._inst_sets is not inst_sets
    else:
        assert (te._key_capacity, te._word_capacity) == caps[:2] and te._tables_version != caps[2]
    np.testing.assert_array_equal(te._req_compat, je._req_compat)
    np.testing.assert_array_equal(te._offer_compat, je._offer_compat)
    np.testing.assert_array_equal(te._row_trivial, je._row_trivial)
    requests = np.zeros((len(jq), len(je.resource_dims)))
    jf = je.feasibility(jrows, requests, je.key_presence(jq))
    tf = te.feasibility(trows, requests, te.key_presence(tq))
    for field in ("compat", "fits", "has_offering"):
        np.testing.assert_array_equal(getattr(tf, field), getattr(jf, field))
