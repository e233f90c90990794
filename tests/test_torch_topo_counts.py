"""The topology count tensors (ops/topo_counts.py) of both packages.

The cases of the reference's tests/test_topo_counts.py — vocabulary
interning, scatter-add updates, the generation sync contract with the host
TopologyGroup oracle, rollback freshness, and gate-vs-oracle agreement on
randomized count states — run against each package, parametrized by its
name. The port's numpy count primitives (`packer.scatter_add_counts`,
`packer.merge_shard_group_counts`) are also held equal to the reference's
on numpy-seeded inputs.
"""

from __future__ import annotations

import importlib
import random

import numpy as np
import pytest

from karpenter_tpu.ops import packer as jpacker
from karpenter_tpu_torch.ops import packer as tpacker

PKGS = ["karpenter_tpu", "karpenter_tpu_torch"]
ZONES = ["z1", "z2", "z3", "z4"]


class _Pkg:
    """The names the cases use, from one package."""

    def __init__(self, pkg):
        def m(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.m = m
        self.wk = m("apis.labels")
        self.core = m("apis.core")
        self.DomainVocab = m("ops.encoding").DomainVocab
        self.scatter_add_counts = m("ops.packer").scatter_add_counts
        tc = m("ops.topo_counts")
        self.AntiGate, self.GroupCounts = tc.AntiGate, tc.GroupCounts
        self.HostAffinityGate, self.SpreadGate = tc.HostAffinityGate, tc.SpreadGate
        self.build_gate = tc.build_gate
        self.topo = m("scheduler.topology")
        reqs = m("scheduling.requirements")
        self.Operator, self.Requirement = reqs.Operator, reqs.Requirement

    def make_pod(self, labels=None):
        c = self.core
        return c.Pod(
            metadata=c.ObjectMeta(name="p", uid="uid-p", labels=labels or {"app": "a"}),
            spec=c.PodSpec(),
        )

    def make_group(self, type_=None, key=None, max_skew=1, min_domains=None, domains=ZONES):
        t = self.topo
        type_ = t.TYPE_SPREAD if type_ is None else type_
        dg = t.TopologyDomainGroup()
        for d in domains:
            dg.insert(d, [])
        return t.TopologyGroup(
            type_,
            key or self.wk.LABEL_TOPOLOGY_ZONE,
            self.make_pod(),
            {"default"},
            self.core.LabelSelector(match_labels={"app": "a"}),
            max_skew if type_ == t.TYPE_SPREAD else t.MAX_SKEW_UNBOUNDED,
            min_domains,
            None,
            None,
            dg,
        )

    def exists(self):
        return self.Requirement("x", self.Operator.EXISTS)


@pytest.fixture(params=PKGS)
def k(request):
    return _Pkg(request.param)


class TestScatterAdd:
    def test_accumulates_duplicates(self, k):
        counts = np.zeros(4, dtype=np.int64)
        counts = k.scatter_add_counts(counts, [1, 1, 3])
        assert counts.tolist() == [0, 2, 0, 1]

    def test_grows_past_capacity(self, k):
        counts = np.zeros(2, dtype=np.int64)
        counts = k.scatter_add_counts(counts, [5])
        assert len(counts) >= 6 and counts[5] == 1

    def test_empty_batch_is_noop(self, k):
        counts = np.ones(2, dtype=np.int64)
        assert k.scatter_add_counts(counts, []) is counts


class TestDomainVocab:
    def test_ids_are_stable_and_append_only(self, k):
        v = k.DomainVocab()
        a = v.id("z1")
        b = v.id("z2")
        assert (a, b) == (0, 1)
        assert v.id("z1") == a  # re-intern keeps the slot
        assert v.lookup("z3") is None
        assert len(v) == 2


class TestGroupCounts:
    def test_mirrors_host_counts(self, k):
        tg = k.make_group()
        tg.record("z1", "z1", "z2")
        gc = k.GroupCounts(tg)
        assert gc.count("z1") == 2
        assert gc.count("z2") == 1
        assert gc.count("z3") == 0  # seeded empty domain
        assert gc.count("nope") == -1

    def test_record_keeps_generations_aligned(self, k):
        tg = k.make_group()
        gc = k.GroupCounts(tg)
        gc.record("z1")
        gc.record("z1", "z2")
        assert gc.synced_gen == tg._gen
        assert gc.count("z1") == tg.domains["z1"] == 2
        assert "z1" not in tg.empty_domains

    def test_out_of_band_mutation_resyncs(self, k):
        tg = k.make_group()
        gc = k.GroupCounts(tg)
        tg.record("z4")  # host oracle path, tensor not told
        assert gc.synced_gen != tg._gen
        gc.fresh()
        assert gc.count("z4") == 1
        assert gc.synced_gen == tg._gen

    def test_tensor_export(self, k):
        tg = k.make_group()
        tg.record("z2")
        gc = k.GroupCounts(tg)
        t = gc.tensor()
        assert t.dtype == np.int64
        assert t[gc.vocab.lookup("z2")] == 1
        assert t.min() >= 0  # absent domains export as 0, not -1

    def test_restore_counts_freshens_generations(self, k):
        clock = k.m("utils.clock").FakeClock()
        store = k.m("runtime.store").Store(clock=clock)
        cluster = k.m("state.cluster").Cluster(clock, store, cloud_provider=None)
        topo = k.topo.Topology(store, cluster, [], [], {}, [])
        tg = k.make_group()
        topo.topology_groups[("k",)] = tg
        snap = topo.snapshot_counts()
        gc = k.GroupCounts(tg)
        gc.record("z1")
        gen_before = tg._gen
        topo.restore_counts(snap)
        assert tg.domains["z1"] == 0  # rolled back
        assert tg._gen != gen_before  # fresh stamp: tensors cannot alias
        assert gc.synced_gen != tg._gen
        gc.fresh()
        assert gc.count("z1") == 0


def _pod_dom(k, rng, tg, domains=ZONES):
    return (
        k.exists()
        if rng.random() < 0.5
        else k.Requirement(tg.key, k.Operator.IN, rng.sample(domains, rng.randint(1, 4)))
    )


class TestGatesMatchOracle:
    """The gates must answer exactly what `tg.get(pod, pod_dom, In[z]).has(z)`
    answers, across randomized count states, in both packages."""

    @pytest.mark.parametrize("seed", range(20))
    def test_spread_gate(self, k, seed):
        rng = random.Random(seed)
        tg = k.make_group(max_skew=rng.choice([1, 2, 3]),
                          min_domains=rng.choice([None, 2, 5]))
        pod = k.make_pod()
        pod_dom = _pod_dom(k, rng, tg)
        gate = k.SpreadGate(k.GroupCounts(tg), pod_dom, tg.selects(pod))
        for _ in range(30):
            gate.gc.record(rng.choice(ZONES))
            z = rng.choice(ZONES + ["unknown"])
            node_row = k.Requirement(tg.key, k.Operator.IN, [z])
            want = tg.get(pod, pod_dom, node_row).has(z)
            assert gate.ok(gate.intern(z)) == want, (z, tg.domains)

    @pytest.mark.parametrize("seed", range(10))
    def test_anti_gate(self, k, seed):
        rng = random.Random(seed)
        tg = k.make_group(type_=k.topo.TYPE_ANTI_AFFINITY)
        pod = k.make_pod()
        pod_dom = _pod_dom(k, rng, tg)
        gate = k.AntiGate(k.GroupCounts(tg), pod_dom, tg.selects(pod))
        for _ in range(20):
            if rng.random() < 0.5:
                gate.gc.record(rng.choice(ZONES))
            z = rng.choice(ZONES)
            node_row = k.Requirement(tg.key, k.Operator.IN, [z])
            want = tg.get(pod, pod_dom, node_row).has(z)
            assert gate.ok(gate.intern(z)) == want

    @pytest.mark.parametrize("seed", range(10))
    def test_affinity_gate(self, k, seed):
        rng = random.Random(seed)
        tg = k.make_group(type_=k.topo.TYPE_AFFINITY)
        pod = k.make_pod()
        pod_dom = _pod_dom(k, rng, tg)
        gate = k.build_gate(k.GroupCounts(tg), pod_dom, tg.selects(pod), pod)
        for _ in range(20):
            if rng.random() < 0.6:
                gate.gc.record(rng.choice(ZONES))
            z = rng.choice(ZONES)
            node_row = k.Requirement(tg.key, k.Operator.IN, [z])
            want = tg.get(pod, pod_dom, node_row).has(z)
            assert gate.ok_with_row(gate.intern(z), z, node_row) == want

    @pytest.mark.parametrize("seed", range(10))
    def test_hostname_affinity_gate(self, k, seed):
        rng = random.Random(seed)
        hosts = [f"h{i}" for i in range(4)]
        tg = k.make_group(type_=k.topo.TYPE_AFFINITY, key=k.wk.LABEL_HOSTNAME, domains=hosts)
        pod = k.make_pod()
        pod_dom = _pod_dom(k, rng, tg, hosts)
        gate = k.HostAffinityGate(tg, pod_dom, tg.selects(pod))
        for _ in range(20):
            if rng.random() < 0.5:
                tg.record(rng.choice(hosts))
            h = rng.choice(hosts + ["h-new"])
            node_row = k.Requirement(tg.key, k.Operator.IN, [h])
            want = tg.get(pod, pod_dom, node_row).has(h)
            assert gate.ok(h) == want


@pytest.mark.parametrize("seed", range(8))
def test_scatter_add_counts_matches_jax(seed):
    """Duplicates accumulate, an index past the end grows the vector, an
    empty batch returns the input itself; amounts of either sign."""
    rng = np.random.RandomState(seed)
    n = int(rng.randint(0, 12))
    counts = rng.randint(0, 5, size=n).astype(np.int64)
    for _ in range(6):
        idx = rng.randint(0, max(1, 2 * n + 3), size=int(rng.randint(0, 10)))
        amount = int(rng.choice([1, 2, -1]))
        want = jpacker.scatter_add_counts(counts.copy(), idx.tolist(), amount)
        got = tpacker.scatter_add_counts(counts.copy(), idx.tolist(), amount)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()
        counts = got
    empty = np.ones(3, dtype=np.int64)
    assert tpacker.scatter_add_counts(empty, []) is empty


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("amounts", [False, True], ids=["ones", "shard_amounts"])
def test_merge_shard_group_counts_matches_jax(seed, amounts):
    """Per-shard group-id streams with duplicates, padding ids past
    num_groups and negative ids, with and without per-entry amounts, merge
    to the reference's vector; it equals np.add.at over the valid ids."""
    rng = np.random.RandomState(100 + seed)
    num_groups = int(rng.randint(1, 20))
    shards = [rng.randint(-2, num_groups + 4, size=int(rng.randint(0, 30)))
              for _ in range(int(rng.randint(1, 9)))]
    amt = [rng.randint(0, 6, size=len(s)) for s in shards] if amounts else None
    want = jpacker.merge_shard_group_counts(shards, num_groups, amt)
    got = tpacker.merge_shard_group_counts(shards, num_groups, amt)
    assert got.dtype == want.dtype == np.int64
    assert got.tolist() == want.tolist()
    ids = np.concatenate(shards) if shards else np.zeros(0, np.int64)
    w = np.concatenate(amt) if amounts else np.ones(len(ids), np.int64)
    keep = (ids >= 0) & (ids < num_groups)
    oracle = np.zeros(num_groups, np.int64)
    np.add.at(oracle, ids[keep], w[keep])
    assert got.tolist() == oracle.tolist()
