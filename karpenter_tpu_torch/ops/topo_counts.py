"""Device-resident topology counting: per-(group, domain) count tensors and
batched admission gates for the topo-aware solver (SURVEY §7 step 3).

The host oracle keeps per-group occupancy in str-keyed dicts and answers
every candidate probe by rebuilding Requirement objects through
`TopologyGroup.get` (topologygroup.go:205-408). This module keeps the SAME
counts as dense vectors over domain vocabularies interned in
ops/encoding.DomainVocab, updated by scatter-add per placement batch, and
answers the solver's admission probes (min/max-skew, affinity seeding,
anti-affinity emptiness) as masked reductions over those vectors — cached
per count-generation, so a probe between placements is one integer compare
plus one indexed read.

Sync contract (the part that keeps host-decision parity trivially true):

- `TopologyGroup` stamps a fresh `_gen` on every count mutation
  (scheduler/topology.py). A tensor is valid iff its `synced_gen` equals
  the group's stamp.
- The solver's record plans route through `GroupCounts.record`, which
  applies the increment to the host dict (still the single source of
  truth for slow-path oracle calls) and scatters the same batch into the
  tensor, re-aligning the stamp.
- Any out-of-band mutation — host `Topology.record` on existing-node
  joins, relaxation updates, rollback via `Topology.restore_counts` —
  drifts the stamp and the next gate read performs a full resync.

Gate semantics are EXACT mirrors of the reference next-domain selection;
branches whose outcome depends on sorted-domain iteration over mutable
state (pod-affinity self-seeding on non-hostname keys) delegate to the
host oracle rather than approximate it. Counters below feed
ffd.solver_cache_counters for tracing/kernel attribution.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from karpenter_tpu_torch.observability import kernels as kobs
from karpenter_tpu_torch.ops.encoding import DomainVocab
from karpenter_tpu_torch.ops.packer import scatter_add_counts
from karpenter_tpu_torch.scheduler.topology import (
    MAX_SKEW_UNBOUNDED,
    TYPE_AFFINITY,
    TYPE_ANTI_AFFINITY,
    TYPE_SPREAD,
    _count_gen,
)

# Attribution counters (process-cumulative; snapshot + delta per solve via
# ffd.solver_cache_counters → solverd solve spans record them as volatile
# attrs, same as the joint/pack cache hits).
GATE_EVALS = 0  # admission verdicts served from count tensors
GATE_REFRESHES = 0  # masked-reduction recomputes after a count change
ORACLE_CALLS = 0  # verdicts delegated to the host TopologyGroup oracle
RESYNCS = 0  # full tensor rebuilds after out-of-band count mutations

# Above this many domains the masked reductions run vectorized over the
# numpy tensor; below it, scalar loops win (zone/capacity-type vocabularies
# are 2-8 domains and numpy's per-call overhead dominates there).
VECTOR_MIN_DOMAINS = 32


class GroupCounts:
    """Count tensor for one TopologyGroup.

    `counts[i]` is the occupancy of `vocab.domains[i]`; -1 marks a domain
    that left the group (unregister) so membership tests stay O(1) without
    re-indexing the vocabulary. `tensor()` exports the dense non-negative
    vector (absent domains as 0) for batch reductions and debug surfaces.
    """

    __slots__ = ("tg", "vocab", "counts", "synced_gen", "_np")

    def __init__(self, tg):
        self.tg = tg
        self.vocab = DomainVocab()
        self.counts: list[int] = []
        self.synced_gen = -1
        self._np: Optional[np.ndarray] = None
        self.resync()

    # -- sync ----------------------------------------------------------------

    def fresh(self) -> "GroupCounts":
        if self.synced_gen != self.tg._gen:
            self.resync()
        return self

    def resync(self) -> None:
        """Full rebuild from the host dict (out-of-band mutation, rollback,
        or first use). Vocabulary ids are stable across resyncs."""
        global RESYNCS
        RESYNCS += 1
        tg = self.tg
        vocab = self.vocab
        for d in tg.domains:
            vocab.id(d)
        dom = tg.domains
        self.counts = [dom.get(d, -1) for d in vocab.domains]
        self._np = None
        self.synced_gen = tg._gen
        # kernel-observatory record: resyncs are the count-tensor layer's
        # "compile" — rare, full rebuilds whose frequency the observatory
        # tracks per domain-vocabulary size (the hot gate evals stay
        # uninstrumented; they are the thing being protected)
        kobs.registry().record_host("topo_counts.resync", str(len(vocab.domains)))

    # -- updates -------------------------------------------------------------

    def record(self, *domains: str) -> None:
        """Placement-batch record: host dict + tensor scatter, stamps
        re-aligned. The choke point every fast-path record plan uses."""
        tg = self.tg
        drifted = self.synced_gen != tg._gen
        if not drifted and len(domains) == 1:
            # single-domain fast path — the overwhelmingly common placement
            # batch; the host-dict update is inlined (record() semantics)
            d = domains[0]
            dom = tg.domains
            dom[d] = dom.get(d, 0) + 1
            tg.empty_domains.discard(d)
            tg._gen = gen = next(_count_gen)
            counts = self.counts
            i = self.vocab.id(d)
            if i >= len(counts):
                counts.extend([-1] * (i + 1 - len(counts)))
            counts[i] = counts[i] + 1 if counts[i] > 0 else 1
            if self._np is not None:
                self._np = scatter_add_counts(self._np, [i])
            self.synced_gen = gen
            return
        tg.record(*domains)
        if drifted:
            self.resync()
            return
        counts = self.counts
        vocab_id = self.vocab.id
        n = len(counts)
        idx = []
        for d in domains:
            i = vocab_id(d)
            if i >= n:
                counts.extend([-1] * (i + 1 - n))
                n = i + 1
            if counts[i] < 0:
                counts[i] = 1
            else:
                counts[i] += 1
            idx.append(i)
        if self._np is not None:
            self._np = scatter_add_counts(self._np, idx)
        self.synced_gen = tg._gen

    def record_shards(self, shard_domain_batches) -> None:
        """Placement-batch record for a mesh-sharded emit: each shard of
        the pod axis reports the domains its local placements landed in,
        and the increments merge into the tensor by ONE segment reduction
        (merge_shard_counts) — duplicates across shards accumulate exactly
        as the sequential host walk would, so the merged tensor is
        bit-identical to recording the flattened stream domain-by-domain
        (spec'd against the TopologyGroup oracle in tests/test_mesh.py).
        The host dict stays the single source of truth: it absorbs the
        same flattened stream through tg.record. NOTE: today's serving
        scan walks placements sequentially and records through `record`;
        this is the merge primitive for emit paths that produce per-shard
        placement batches (the device-resident scan, ROADMAP item 2)."""
        flat = [d for batch in shard_domain_batches for d in batch]
        if not flat:
            return
        tg = self.tg
        drifted = self.synced_gen != tg._gen
        tg.record(*flat)
        if drifted:
            self.resync()
            return
        counts = self.counts
        vocab_id = self.vocab.id
        idx_batches = []
        for batch in shard_domain_batches:
            ids = []
            for d in batch:
                i = vocab_id(d)
                if i >= len(counts):
                    counts.extend([-1] * (i + 1 - len(counts)))
                # -1 marks an absent domain; first increment revives it at 1
                if counts[i] < 0:
                    counts[i] = 0
                ids.append(i)
            idx_batches.append(np.asarray(ids, dtype=np.int64))
        merged = merge_shard_counts(idx_batches, len(counts))
        for i in np.nonzero(merged)[0]:
            counts[int(i)] += int(merged[i])
        if self._np is not None:
            self._np = None  # rebuilt lazily from the merged host list
        self.synced_gen = tg._gen

    # (no register() counterpart: hostname groups — the only registration
    # path in the solver — stay dict-backed, so registrations go straight
    # to the host group and any tensor resyncs on the gen drift)

    # -- reads ---------------------------------------------------------------

    def count(self, domain: str) -> int:
        """Occupancy of `domain`, -1 when the domain is not in the group."""
        i = self.vocab.lookup(domain)
        if i is None or i >= len(self.counts):
            return -1
        return self.counts[i]

    def tensor(self) -> np.ndarray:
        """Dense int64 occupancy vector over the vocabulary (absent
        domains as 0) — the export surface for batch reductions, tests,
        and /debug introspection."""
        if self._np is None or len(self._np) != len(self.counts):
            self._np = np.maximum(np.asarray(self.counts, dtype=np.int64), 0)
        return self._np


def merge_shard_counts(
    shard_idx_batches, size: int, amount: int = 1
) -> np.ndarray:
    """Segment-reduce per-shard domain-id increment streams into one dense
    [size] vector: the merge-at-emit step of a mesh-sharded placement
    batch. One implementation of the mask-and-scatter semantics
    (ops/packer.merge_shard_group_counts); every kept index contributes
    `amount`. Indices outside [0, size) are padding remainders and
    contribute nothing."""
    from karpenter_tpu_torch.ops.packer import merge_shard_group_counts

    out = merge_shard_group_counts(shard_idx_batches, size)
    return out * amount if amount != 1 else out


def _unconstrained(req) -> bool:
    """Mirror of the host's 'pod domains are Exists' test
    (_domain_min_count): complement with no explicit values or bounds."""
    return (
        req.complement
        and not req.values
        and req.greater_than is None
        and req.less_than is None
    )


class SpreadGate:
    """min/max-skew admission for one (shape group × spread group) pair.

    `ok(domain_id)` answers the host's fast-plan probe
    `tg.get(pod, pod_domains, In[z]).has(z)` for non-hostname keys: z is
    admissible iff it is a known domain and counts[z] (+1 when the pod
    selects itself) minus the min count over the pod-supported domains is
    within maxSkew (topologygroup.go:229-273 + minDomains rule). The
    verdict set over ALL domains is one masked reduction, recomputed only
    when the group's count generation moves.
    """

    __slots__ = ("gc", "pod_domains", "self_sel", "gen", "_bound", "_sup")

    def __init__(self, gc: GroupCounts, pod_domains, self_selecting: bool):
        self.gc = gc
        self.pod_domains = pod_domains
        self.self_sel = 1 if self_selecting else 0
        self.gen = -1
        self._bound = -1  # admissible iff 0 <= counts[id] <= _bound
        self._sup: Optional[list[bool]] = None  # pod-supported mask (static)

    def intern(self, domain: str) -> int:
        return self.gc.vocab.id(domain)

    def _refresh(self) -> None:
        global GATE_REFRESHES
        GATE_REFRESHES += 1
        gc = self.gc.fresh()
        tg = gc.tg
        counts = gc.counts
        n = len(counts)
        pod = self.pod_domains
        if _unconstrained(pod):
            supported_of = None
        else:
            sup = self._sup
            if sup is None or len(sup) < n:
                has = pod.has
                sup = self._sup = [has(d) for d in gc.vocab.domains]
            supported_of = sup
        # masked min over supported present domains (+ supported cardinality
        # for the minDomains override); the verdict over ALL domains then
        # collapses to one bound: admissible iff 0 <= count <= bound
        if n >= VECTOR_MIN_DOMAINS:
            arr = np.asarray(counts, dtype=np.int64)
            present = arr >= 0
            sup_m = (
                present
                if supported_of is None
                else (present & np.asarray(supported_of[:n]))
            )
            n_sup = int(sup_m.sum())
            min_count = int(arr[sup_m].min()) if n_sup else MAX_SKEW_UNBOUNDED
        else:
            min_count = MAX_SKEW_UNBOUNDED
            n_sup = 0
            for i in range(n):
                c = counts[i]
                if c < 0 or (supported_of is not None and not supported_of[i]):
                    continue
                n_sup += 1
                if c < min_count:
                    min_count = c
        if tg.min_domains is not None and n_sup < tg.min_domains:
            min_count = 0
        self._bound = tg.max_skew + min_count - self.self_sel
        self.gen = gc.synced_gen

    def ok(self, domain_id: int) -> bool:
        global GATE_EVALS
        GATE_EVALS += 1
        gc = self.gc
        if self.gen != gc.tg._gen:
            self._refresh()
        counts = gc.counts
        if domain_id >= len(counts):
            return False
        return 0 <= counts[domain_id] <= self._bound


class AntiGate:
    """Anti-affinity admission on non-hostname keys: z is admissible iff it
    is a known, still-empty domain the pod's own row supports
    (topologygroup.go:389-407 over a single-valued node row). Emptiness
    only shrinks during a solve, so verdicts flip at most once."""

    __slots__ = ("gc", "pod_domains", "gen", "_ok")

    def __init__(self, gc: GroupCounts, pod_domains, self_selecting: bool):
        self.gc = gc
        self.pod_domains = pod_domains
        self.gen = -1
        self._ok: list[bool] = []

    def intern(self, domain: str) -> int:
        return self.gc.vocab.id(domain)

    def _refresh(self) -> None:
        global GATE_REFRESHES
        GATE_REFRESHES += 1
        gc = self.gc.fresh()
        has = self.pod_domains.has
        self._ok = [
            c == 0 and has(d)
            for c, d in zip(gc.counts, gc.vocab.domains)
        ]
        self.gen = gc.synced_gen

    def ok(self, domain_id: int) -> bool:
        global GATE_EVALS
        GATE_EVALS += 1
        if self.gen != self.gc.tg._gen:
            self._refresh()
        ok = self._ok
        return domain_id < len(ok) and ok[domain_id]


class AffinityGate:
    """Pod-affinity admission on non-hostname keys. The countable case — z
    is a known domain with matching pods the pod's row supports — is a
    tensor read. The self-seeding branch (nothing matched anywhere, or no
    compatible domain has a match; topologygroup.go:322-343) picks domains
    by sorted iteration over mutable state, so it DELEGATES to the host
    oracle with the shape representative instead of approximating."""

    __slots__ = ("gc", "pod_domains", "self_selecting", "rep", "gen", "_pos", "_seed")

    def __init__(self, gc: GroupCounts, pod_domains, self_selecting: bool, rep):
        self.gc = gc
        self.pod_domains = pod_domains
        self.self_selecting = self_selecting
        self.rep = rep  # shape representative; selects(rep) == selects(pod)
        self.gen = -1
        self._pos: list[bool] = []
        self._seed = False

    def intern(self, domain: str) -> int:
        return self.gc.vocab.id(domain)

    def _refresh(self) -> None:
        global GATE_REFRESHES
        GATE_REFRESHES += 1
        gc = self.gc.fresh()
        has = self.pod_domains.has
        pos = []
        all_empty = True
        any_compat = False
        for c, d in zip(gc.counts, gc.vocab.domains):
            p = c > 0 and has(d)
            pos.append(p)
            if c > 0:
                all_empty = False
                if p:
                    any_compat = True
        self._pos = pos
        self._seed = self.self_selecting and (all_empty or not any_compat)
        self.gen = gc.synced_gen

    def ok_with_row(self, domain_id: int, domain: str, node_row) -> bool:
        global GATE_EVALS, ORACLE_CALLS
        GATE_EVALS += 1
        if self.gen != self.gc.tg._gen:
            self._refresh()
        pos = self._pos
        if domain_id < len(pos) and pos[domain_id]:
            return True
        if not self._seed:
            return False
        # self-seed branch: host-oracle exact (sorted-domain iteration)
        ORACLE_CALLS += 1
        return self.gc.tg.get(self.rep, self.pod_domains, node_row).has(domain)


class HostAffinityGate:
    """Pod-affinity admission on the HOSTNAME key. Hostnames are claim-local
    domains, so this gate reads the host dict directly — one lookup per
    claim — and gen-caches only the GLOBAL self-seed condition (nothing
    matched anywhere / no compatible domain has a match; the hostname
    branch of topologygroup.go:337-353 inserts the claim's own hostname
    exactly then)."""

    __slots__ = ("tg", "pod_domains", "self_selecting", "gen", "_seed")

    def __init__(self, tg, pod_domains, self_selecting: bool):
        self.tg = tg
        self.pod_domains = pod_domains
        self.self_selecting = self_selecting
        self.gen = -1
        self._seed = False

    def ok(self, hostname: str) -> bool:
        global GATE_EVALS, GATE_REFRESHES
        GATE_EVALS += 1
        if not self.pod_domains.has(hostname):
            return False
        tg = self.tg
        if tg.domains.get(hostname, 0) > 0:
            return True
        if not self.self_selecting:
            return False
        if self.gen != tg._gen:
            GATE_REFRESHES += 1
            has = self.pod_domains.has
            self._seed = len(tg.domains) == len(tg.empty_domains) or not any(
                c > 0 and has(d) for d, c in tg.domains.items()
            )
            self.gen = tg._gen
        return self._seed


def build_gate(gc: GroupCounts, pod_domains, self_selecting: bool, rep):
    """Compile the admission gate for one (shape group × topology group)
    pair; the join-plan evaluator calls gate.ok(domain_id) per family."""
    t = gc.tg.type
    if t == TYPE_SPREAD:
        return SpreadGate(gc, pod_domains, self_selecting)
    if t == TYPE_ANTI_AFFINITY:
        return AntiGate(gc, pod_domains, self_selecting)
    assert t == TYPE_AFFINITY
    return AffinityGate(gc, pod_domains, self_selecting, rep)


def gate_counters() -> dict:
    """Cumulative gate/oracle counters (delta two snapshots to attribute
    one solve — same pattern as ffd.solver_cache_counters)."""
    return {
        "topo_gate_evals": GATE_EVALS,
        "topo_gate_refreshes": GATE_REFRESHES,
        "topo_oracle_calls": ORACLE_CALLS,
        "topo_tensor_resyncs": RESYNCS,
    }
