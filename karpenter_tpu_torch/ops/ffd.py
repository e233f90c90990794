"""Device-accelerated first-fit-decreasing: the CUDA fast path of the
provisioning solve, with EXACT host-decision parity. The batched
feasibility sweep runs through CatalogEngine (ops/catalog.py) on the card;
the walk itself runs as the fused scan kernel on a CUDA engine
(ops/fused.py), else in the native C++ driver.

The reference's solver is a per-pod loop — Pop → try existing nodes →
try in-flight claims (emptiest first) → open a new claim from the weighted
templates (scheduler.go:346-401, :451-557). Its hottest inner op is
`filterInstanceTypesByRequirements` over every instance type
(nodeclaim.go:373-441). This module reshapes that work device-first while
reproducing the host loop's decisions bit-for-bit:

1. Pods collapse into groups of identical spec shapes; pod data (requirement
   parsing) runs ONCE per distinct shape instead of once per pod.
2. ONE batched device call evaluates the joint (template x group)
   requirement feasibility over the catalog — packed-bit membership kernels
   (CatalogEngine.feasibility). Set compatibility is a per-requirement AND
   (requirements.go:248-268), so AND-ing the cached row vectors of the TRUE
   joint requirement set (whose rows are the per-key intersections produced
   by Requirements.add) is bit-identical to the host filter — including the
   per-offering cross-key conjunction the pairwise masks miss.
3. The packing loop is an EXACT simulation of the host queue: pods are
   processed in the host's sort order (cpu desc, mem desc, timestamp, uid;
   queue.go:72-108), each pod tries existing nodes in order, then in-flight
   claims in the host's emptiest-first *stable-sort* order, then the
   weighted templates. Every rejection reason is monotone (requirements
   only narrow, usage only grows, limits only shrink), so rejections are
   cached permanently and steady-state placements cost O(1) per pod:
   lazy-keyed heaps model the stable sort, per-(claim, group) capacity
   schedules replace the per-pod filter.
4. Higher-order joint requirement sets (a claim accumulating several
   narrowing groups) are evaluated host-side from the engine's cached row
   matrices — exact, no device round-trip on the sequential path.

Eligibility is checked first (`eligible`). Every scheduling construct runs
on the device path: topology, host ports, volumes, hostname pins, minValues
in BOTH policies (Strict's per-join diversity gate; BestEffort's open-time
relaxation into per-claim specs), reserved capacity in BOTH offering modes
(fallback bookkeeping per join; strict's scan-aborting errors on the
all-volatile topo driver), and PreferNoSchedule relaxation. The host loop
remains the semantics oracle. On a CUDA engine the whole walk runs first as
the fused one-dispatch scan (ops/fused.py, csrc/scan.cu); batches it
declines by shape run on the walk here. Topology-engaged, host-port/volume,
hostname, PreferNoSchedule, and strict-reserved solves run the topo-aware
driver (ops/ffd_topo.py).
"""

from __future__ import annotations

import heapq
import itertools
import time
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.observability import explain as explmod
from karpenter_tpu_torch.scheduler.nodeclaim import InstanceTypeFilterError
from karpenter_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.scheduling.hostportusage import HostPortUsage
from karpenter_tpu_torch.scheduling.requirements import Operator
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.utils import resources as res

if TYPE_CHECKING:
    from karpenter_tpu_torch.ops.catalog import CatalogEngine

# Below this batch size the host per-pod loop is comfortably fast and covers
# every feature; the device path's fixed costs don't pay off.
DEVICE_MIN_PODS = 64
# Existing-node joins run through host requirement algebra per (node, group)
# pair with monotone scan pointers, so large clusters stay O(nodes + pods);
# the cap is a safety valve for pathological node counts. 4096 keeps the
# 1k-candidate consolidation simulations (7 binary-search rounds over ~1000
# surviving nodes each) on the fast path.
DEVICE_MAX_EXISTING = 4096

# Observability: how often the fast path ran vs fell back. Mirrored into the
# metrics registry so operators can alert on fallback storms.
DEVICE_SOLVES = 0
DEVICE_FALLBACKS = 0
_SOLVES_CTR = global_registry.counter(
    "karpenter_scheduler_device_solves_total",
    "scheduling solves served by the device fast path",
)
_FALLBACKS_CTR = global_registry.counter(
    "karpenter_scheduler_device_fallbacks_total",
    "scheduling solves that fell back to the host loop",
)
# Joint-mask device sweeps: each increment is one batched [P, I] feasibility
# cube dispatch over fresh joint requirement sets. solverd's coalescer uses
# this to prove concurrent solves sharing an engine merged into ONE batch.
JOINT_SWEEPS = 0
_JOINT_SWEEPS_CTR = global_registry.counter(
    "karpenter_solver_joint_sweeps_total",
    "batched joint-requirement feasibility sweeps dispatched to the device path",
)
# Cache-hit attribution for the engine-shared solver caches: the solverd
# solve span snapshots these around each solve so slow solves can be
# attributed to cold caches vs device work. Process-history state — span
# code records the deltas as VOLATILE attrs (excluded from deterministic
# span digests; a warm second run legitimately hits where a cold first run
# missed).
JOINT_CACHE_HITS = 0
JOINT_CACHE_MISSES = 0
PACK_CACHE_HITS = 0
PACK_CACHE_MISSES = 0


def solver_cache_counters() -> dict:
    """Snapshot of the solver's cumulative cache/dispatch counters (delta
    two snapshots to attribute one solve): the plain driver's counters, the
    fused scan's (solves + decline taxonomy) and the delta residency's.
    Includes the topology count-gate counters (ops/topo_counts.py) so
    solve spans can attribute a slow topo solve to oracle fallbacks /
    tensor resyncs the same way they attribute cold joint/pack caches."""
    from karpenter_tpu_torch.ops import topo_counts

    out = {
        "joint_cache_hits": JOINT_CACHE_HITS,
        "joint_cache_misses": JOINT_CACHE_MISSES,
        "pack_cache_hits": PACK_CACHE_HITS,
        "pack_cache_misses": PACK_CACHE_MISSES,
        "joint_sweeps": JOINT_SWEEPS,
        "device_solves": DEVICE_SOLVES,
        "device_fallbacks": DEVICE_FALLBACKS,
    }
    out.update(topo_counts.gate_counters())
    # lazy import keeps the ffd<->fused module cycle one-directional at import
    from karpenter_tpu_torch.ops import fused as _fused

    out.update(_fused.fused_counters())
    # incremental-solve residency accounting (ops/delta.py): warm/cold
    # passes, bytes re-encoded, scan resume outcomes, self-check verdicts —
    # snapshot-and-delta attributes one solve's delta behavior the same way
    from karpenter_tpu_torch.ops import delta as _delta

    out.update(_delta.delta_counters())
    return out


# /metrics mirror of solver_cache_counters: the module-global ints above are
# span-visible only (volatile solve attrs); operators alerting on e.g. the
# affinity self-seed host-delegation path regressing need topo_oracle_calls
# as a scrapeable counter. publish_cache_counters() diffs the cumulative
# snapshot against the last published values and inc()s the delta — called
# after every solverd batch (solverd/service.run_pending), so the series
# lag a batch at most.
_CACHE_EVENTS_CTR = global_registry.counter(
    "karpenter_solver_cache_events_total",
    "cumulative solver cache/dispatch/delegation events "
    "(ffd.solver_cache_counters: joint/pack cache hits+misses, joint "
    "sweeps, device solves/fallbacks, topo gate evals/refreshes, "
    "topo_oracle_calls, tensor resyncs)",
    labels=["event"],
)
_published_cache_counters: dict[str, int] = {}


def publish_cache_counters() -> dict:
    """Mirror the cumulative solver cache counters onto /metrics; returns
    the snapshot it published."""
    snap = solver_cache_counters()
    for name, value in snap.items():
        prev = _published_cache_counters.get(name, 0)
        if value > prev:
            _CACHE_EVENTS_CTR.inc({"event": name}, value - prev)
            _published_cache_counters[name] = value
    return snap


_EPS = 1e-9
_BIG = np.int64(2**31)

_placeholder_counter = itertools.count(1)

# process-global shape-signature interning: the full _raw_sig tuple hashes in
# microseconds at 50k pods, so pods carry a small int instead and per-solve
# group lookup is an int-keyed dict hit. The dict is cleared at a cap to
# bound memory on high shape diversity; ids come from a never-reset counter,
# so a re-interned shape gets a fresh id and its old/new pods merely split
# into two value-identical groups (dedup cost, never a correctness issue).
_SIG_IDS: dict[tuple, int] = {}
_SIG_NEXT = itertools.count()
_SIG_CAP = 200_000
# engine-shared cross-solve caches (joint requirement masks, family
# transitions) share one cap; see set_memory_budget
_ENGINE_CACHE_CAP = 100_000


def _evict_lru(cache: dict, cap: int) -> None:
    """Trim an engine-shared cache to ~90% of `cap`, dropping the LEAST
    recently touched entries. Python dicts iterate in insertion order and
    every cache hit reinserts its entry at the tail, so iteration order IS
    recency order — the head is the coldest entry. Unlike the previous
    wholesale clear(), hitting the cap costs only the cold tail, never the
    warm working set."""
    if len(cache) <= cap:
        return
    drop = len(cache) - (cap - cap // 10)
    for k in list(itertools.islice(iter(cache), drop)):
        del cache[k]


def set_memory_budget(limit_mib: int) -> None:
    """Bound the solver's unbounded-by-default caches to a memory budget.

    The reference wires --memory-limit into GOMEMLIMIT at 90%
    (pkg/operator/operator.go:115-118) so the GC keeps the process under
    its cgroup. Python has no GC ceiling; the operator's only unbounded
    memory consumers are these interning/memo caches, so the budget
    scales their clear-at caps instead. Sizing: a signature tuple runs
    ~300B, a joint-mask entry ~1KiB — defaults (200k/100k) assume ~160MiB
    of cache headroom; the caps scale linearly below that and never rise
    above the defaults."""
    global _SIG_CAP, _ENGINE_CACHE_CAP
    if limit_mib is None or limit_mib <= 0:
        _SIG_CAP, _ENGINE_CACHE_CAP = 200_000, 100_000
        return
    scale = min(1.0, limit_mib / 160.0)
    _SIG_CAP = max(1_000, int(200_000 * scale))
    _ENGINE_CACHE_CAP = max(1_000, int(100_000 * scale))


# -- eligibility -------------------------------------------------------------


def eligible(scheduler, pods: Sequence[Pod]) -> bool:
    """True when the device path can reproduce host semantics for this solve
    (solve-level gates; per-pod gates run once per GROUP during grouping).
    Topology-engaged solves are additionally gated by ffd_topo.supported()
    inside solve_device — spread-only solves run the topo-aware driver."""
    if scheduler.engine is None:
        return False
    if len(pods) < DEVICE_MIN_PODS:
        # DEVICE_MIN_PODS is a dispatch-RTT heuristic, not a correctness
        # gate. An operator that forced the fused path AND incremental
        # delta solves has opted into device-resident state — tiny churn
        # batches are exactly the traffic that mode exists for, and
        # bouncing them to the host walk would both skip the warm
        # scan-resume and force a host resync of the count tensors.
        from karpenter_tpu_torch.ops import delta as delta_mod
        from karpenter_tpu_torch.ops import fused as fused_mod

        if not (delta_mod.delta_enabled() and fused_mod.FUSED_MODE == "on"):
            return False
    if len(scheduler.existing_nodes) > DEVICE_MAX_EXISTING:
        return False
    # PreferNoSchedule pools extend the relax ladder with the wildcard
    # toleration rung (preferences.go:133-145): every pod is potentially
    # relaxable, so those solves route straight to the topo driver (which
    # relaxes exactly like the host) — see solve_device.
    # Reserved capacity is device-supported in BOTH modes. Fallback (the
    # default): bookkeeping runs on every join exactly like the host's
    # can_add→Add cycle and never REJECTS a candidate, so the monotone
    # machinery stays sound. Strict: reservation exhaustion raises
    # scan-aborting ReservedOfferingErrors (scheduler.go:519,574
    # short-circuits) — non-monotone, so those solves route to the topo
    # driver with every shape volatile (see solve_device/_prepare_templates).
    # The catalog scan is cached on the (immutable) engine catalog.
    if scheduler.reserved_capacity_enabled:
        has_reserved = getattr(scheduler.engine, "_kt_has_reserved", None)
        if has_reserved is None:
            has_reserved = any(
                o.capacity_type == wk.CAPACITY_TYPE_RESERVED
                for it in scheduler.engine.instance_types
                for o in it.offerings
            )
            scheduler.engine._kt_has_reserved = has_reserved
    dims = scheduler.engine.resource_dims
    for nct in scheduler.nodeclaim_templates:
        # minValues is fully supported in BOTH policies. Strict: monotone
        # (narrowing only shrinks the distinct-value count, so rejections
        # are permanent). BestEffort: relaxation happens once per claim at
        # OPEN (nodeclaim.go:425-436) into per-claim specs — interned family
        # rows are never mutated, and joins gate on the relaxed values just
        # like the host's max-merged claim requirements.
        # hostname-constrained templates would break family sharing (the
        # canonical family Requirements are hostname-free)
        if nct.requirements.has(wk.LABEL_HOSTNAME):
            return False
        if any(k not in dims for k in scheduler.daemon_overhead[nct]):
            return False
    return True


def _strict_reserved(scheduler) -> bool:
    """One predicate for strict-mode reserved routing — shared by
    solve_device's driver selection and _DeviceSolve.strict_res so the two
    can never disagree."""
    if not (
        scheduler.reserved_capacity_enabled
        and getattr(scheduler.engine, "_kt_has_reserved", False)
    ):
        return False
    from karpenter_tpu_torch.scheduler.nodeclaim import RESERVED_OFFERING_MODE_STRICT

    return scheduler.reserved_offering_mode == RESERVED_OFFERING_MODE_STRICT


def _has_pod_affinity_terms(aff) -> bool:
    """Termless PodAffinity/PodAntiAffinity objects are inert — they create
    no topology groups and the relax ladder skips them."""
    pa = aff.pod_affinity
    if pa is not None and (pa.required or pa.preferred):
        return True
    panti = aff.pod_anti_affinity
    if panti is not None and (panti.required or panti.preferred):
        return True
    return False


def _group_eligible(pod: Pod) -> bool:
    """Per-shape gates, checked once per distinct pod shape."""
    spec = pod.spec
    aff = spec.affinity
    if aff is not None:
        if _has_pod_affinity_terms(aff):
            return False
        na = aff.node_affinity
        if na is not None and (na.preferred or len(na.required) > 1):
            return False
    if spec.topology_spread_constraints:
        return False
    if any(c.ports for c in list(spec.containers) + list(spec.init_containers)):
        return False
    if getattr(spec, "volumes", None):
        return False
    return True


# -- grouping ----------------------------------------------------------------


class _Group:
    __slots__ = (
        "reqs", "strict_reqs", "requests", "req_f", "div_dims", "div_req",
        "tier", "fit_floor", "sort_cpu", "sort_mem", "n_pods", "rowset",
        "has_hostname", "req_list", "floor_list",
    )

    def __init__(self, data, dims: dict):
        self.reqs: Requirements = data.requirements
        self.strict_reqs: Requirements = data.strict_requirements
        self.requests: dict = data.requests
        self.req_f = np.zeros(len(dims), dtype=np.float64)
        for name, v in data.requests.items():
            self.req_f[dims[name]] = v
        self.div_dims = np.nonzero(self.req_f > 0)[0]
        self.div_req = self.req_f[self.div_dims]
        # Resource tier: groups with IDENTICAL request vectors share claim
        # capacity schedules (fits depends only on the vector, not the group).
        self.tier = self.req_f.tobytes()
        # Fit threshold: usage + req <= alloc + eps  ⟺  rem >= req - eps
        self.fit_floor = self.req_f - 1e-9
        # Python-scalar mirrors for the deferred-claim fast path (the
        # per-join admission/commit run scalar loops over D dims — cheaper
        # than numpy dispatch at D ~ 8)
        self.req_list = self.req_f.tolist()
        self.floor_list = self.fit_floor.tolist()
        self.sort_cpu = data.requests.get(wk.RESOURCE_CPU, 0.0)
        self.sort_mem = data.requests.get(wk.RESOURCE_MEMORY, 0.0)
        self.n_pods = 0
        self.rowset: frozenset = frozenset()  # filled once the engine interns
        self.has_hostname = any(r.key == wk.LABEL_HOSTNAME for r in data.requirements)


def _raw_sig(pod: Pod) -> tuple:
    """Cheap value-signature over every spec field that can influence an
    ELIGIBLE pod's scheduling: selector, single required affinity term,
    container resources, tolerations, and the eligibility-gate fields
    themselves (so an ineligible pod can never hide inside an eligible
    group). Dict items are taken in insertion order — two value-equal specs
    built in different key orders merely split into two identical groups,
    which only costs dedup, never correctness. Runs once per pod."""
    spec = pod.spec
    containers = spec.containers
    # fast path: the overwhelmingly common single-container plain pod
    if (
        spec.affinity is None
        and not spec.topology_spread_constraints
        and not spec.tolerations
        and not spec.init_containers
        and not spec.overhead
        and not getattr(spec, "volumes", None)
        and len(containers) == 1
    ):
        c = containers[0]
        return (
            tuple(spec.node_selector.items()) if spec.node_selector else (),
            tuple(c.requests.items()),
            tuple(c.limits.items()) if c.limits else (),
            len(c.ports),
            c.restart_policy,
        )
    aff = spec.affinity
    aff_sig: tuple = ()
    gates = 1
    if aff is not None:
        # non-empty only: must mirror _group_eligible so a termed pod can
        # never share a signature with an eligible termless one
        if _has_pod_affinity_terms(aff):
            gates |= 2
        na = aff.node_affinity
        if na is not None:
            if na.preferred:
                gates |= 4
            aff_sig = tuple(
                tuple(
                    (e["key"], e["operator"], tuple(e.get("values", ())))
                    for e in term.match_expressions
                )
                for term in na.required
            )
    if spec.topology_spread_constraints:
        gates |= 8
    if getattr(spec, "volumes", None):
        gates |= 16
    cont_sig = tuple(
        (
            tuple(c.requests.items()),
            tuple(c.limits.items()) if c.limits else (),
            len(c.ports),
            c.restart_policy,
        )
        for c in containers
    )
    inits = ()
    if spec.init_containers:
        inits = tuple(
            (
                tuple(c.requests.items()),
                tuple(c.limits.items()) if c.limits else (),
                c.restart_policy,
            )
            for c in spec.init_containers
        )
    return (
        tuple(spec.node_selector.items()) if spec.node_selector else (),
        aff_sig,
        gates,
        cont_sig,
        inits,
        tuple(spec.overhead.items()) if spec.overhead else (),
        tuple((t.key, t.operator, t.value, t.effect) for t in spec.tolerations)
        if spec.tolerations
        else (),
    )


# -- simulation structures ---------------------------------------------------


class _Claim:
    """An in-flight NodeClaim under simulation.

    Fits-narrowing TELESCOPES: because usage only grows, the host's per-join
    option filter satisfies types_k = types_0 ∧ fits(U_k). The claim keeps
    the remaining headroom `rem = allocatable − usage` over exactly the
    UNIQUE allocatable vectors that still fit the current usage — rows that
    stop fitting are pruned permanently, so every join is a handful of
    small-array ops; the emitted option set is type_mask ∧ surviving rows.

    Requirement state is an interned FAMILY id: claims sharing a requirement
    row-set share one id, one canonical (hostname-free) Requirements object,
    and one memoized join-transition table — the expensive requirement
    algebra runs once per (family, group), not once per (claim, group)."""

    __slots__ = (
        "ti", "fam", "hostname", "type_mask", "u_ids", "rem", "count", "rank",
        "members", "group_counts", "gdrop", "gknown", "reserved",
        "min_specs", "min_relaxed", "hn_epoch", "defer",
    )

    def __init__(self, ti, fam, hostname, type_mask, u_ids, rem, rank):
        self.ti = ti
        self.fam = fam  # interned row-set family id
        self.hostname = hostname  # per-claim placeholder value
        self.type_mask = type_mask  # np bool [I]: requirement-level narrowing
        self.u_ids = u_ids  # np int [M] unique-allocatable row ids
        self.rem = rem  # np float64 [M, D] uniq_alloc - current usage
        self.count = 0
        self.rank = rank
        self.members: list[Pod] = []
        self.group_counts: dict[int, int] = {}  # TOTAL pods per group
        self.gdrop: set[int] = set()  # groups permanently rejected
        # Groups whose requirements are subsumed by the claim's (adding them
        # is a no-op). Subsumption survives further narrowing, so membership
        # is permanent.
        self.gknown: set[int] = set()
        # reserved offerings currently held (nodeclaim.go:166-205), refreshed
        # on every successful join like the host's can_add→Add cycle
        self.reserved: list = []
        # minValues specs governing this claim's joins. Strict: the
        # template's. BestEffort: relaxed AT OPEN to the achievable distinct
        # count (nodeclaim.go:425-436) — fixed thereafter, exactly like the
        # host claim whose relaxed requirement min_values max-merge through
        # every later join.
        self.min_specs: list[tuple[str, int]] = []
        self.min_relaxed = False
        # hostname-register epoch (topo driver): the epoch of the hostname
        # topology-group set this claim's hostname was last registered into.
        # Registration is idempotent, so each (claim, group-set epoch) pays
        # exactly one pass over the hostname groups instead of one per join.
        self.hn_epoch = -1
        # Deferred row-pruning state (topo driver fast path), or None.
        # (pareto_rows, extra): `pareto_rows` are the Pareto-maximal rows of
        # the OPEN-time headroom matrix as Python lists; `extra` accumulates
        # the requests joined since open. Row pruning telescopes — a row
        # survives all joins iff alloc >= final usage - eps per dim — so
        # admission is a pareto check against (row - extra) and the full
        # rem/u_ids narrowing is materialized only when a slow path, a
        # minValues/reserved gate, or emit actually reads the rows
        # (_DeviceSolve._materialize).
        self.defer = None


class _Node:
    """Existing-node wrapper; mutations are committed to the scheduler's
    ExistingNode objects only at emit."""

    __slots__ = (
        "en", "reqs", "remaining", "version", "usage_ver", "joined",
        "gtol", "gcompat", "gcap",
    )

    def __init__(self, en):
        self.en = en
        self.reqs = en.requirements
        self.remaining = dict(en.remaining_resources)
        self.version = 0
        self.usage_ver = 0
        self.joined: list[Pod] = []
        self.gtol: dict[int, bool] = {}
        self.gcompat: dict[int, tuple[int, bool]] = {}  # gi -> (version, ok)
        self.gcap: dict[int, tuple[int, int]] = {}  # gi -> (usage_ver, k_left)


class _LazyNodes:
    """Sequence facade over the scheduler's ExistingNodes that materializes
    _Node wrappers on first touch. The monotone FFD scan (_try_nodes) only
    ever reads a prefix of the node order — consolidation simulations pack
    a few hundred pods into the first handful of nodes — so building all
    ~1k wrappers up front was the single largest steady-state solve cost at
    frontier scale. Full iteration (the topo driver's volatile scans, abort
    snapshots) materializes everything, preserving exact semantics;
    `materialized()` exposes only touched wrappers for emit, where an
    untouched node is by construction join-free."""

    __slots__ = ("_ens", "_built")

    def __init__(self, existing_nodes):
        self._ens = existing_nodes
        self._built: list = [None] * len(existing_nodes)

    def __len__(self) -> int:
        return len(self._built)

    def __bool__(self) -> bool:
        return bool(self._built)

    def __getitem__(self, i: int) -> "_Node":
        nd = self._built[i]
        if nd is None:
            nd = self._built[i] = _Node(self._ens[i])
        return nd

    def __iter__(self):
        for i in range(len(self._built)):
            yield self[i]

    def materialized(self):
        return (nd for nd in self._built if nd is not None)


class _Fallback(Exception):
    """Internal: abort the device solve and use the host loop."""


class _IneligibleShape(_Fallback):
    """A pod shape the current driver declines. From the plain driver this
    triggers a retry on the topo driver (whose relax ladder handles
    preferred/multi-term node affinity); from the topo driver it falls
    back to the host loop."""


class _NativeDriver:
    """Drives the C steady-state kernel (ops/_native/ffd_kernel.cc).

    The kernel owns the queue, per-group heaps, and claim headroom state;
    this driver answers its four up-calls — taint tolerance, family-join
    transitions, new-claim openings, existing-node joins — using the same
    _DeviceSolve methods the Python loop uses, so both drivers share one
    semantics implementation for everything that isn't a hot loop."""

    def __init__(self, solve: "_DeviceSolve", pods_sorted: list, gi_arr, timeout):
        from karpenter_tpu_torch.ops import native as nat

        self.nat = nat
        self.lib = nat.get_lib()
        self.s = solve
        self.pods = pods_sorted
        s = solve
        G, D = len(s.groups), s.D
        self.W = max(1, (s.I + 63) // 64)
        g_req = (
            np.ascontiguousarray(np.stack([g.req_f for g in s.groups]))
            if s.groups
            else np.zeros((0, D))
        )
        g_fit = (
            np.ascontiguousarray(np.stack([g.fit_floor for g in s.groups]))
            if s.groups
            else np.zeros((0, D))
        )
        utype = np.zeros((s.U, self.W), dtype=np.uint64)
        for u in range(s.U):
            utype[u] = self._pack(s.uid_of_type == u)
        utype = np.ascontiguousarray(utype)
        # nonzero request dims per group: the C fit/subtract loops touch
        # only these (zero dims provably always pass)
        g_ndim = np.zeros(G, dtype=np.int32)
        g_didx = np.zeros((G, D), dtype=np.int32)
        for k, g in enumerate(s.groups):
            g_ndim[k] = len(g.div_dims)
            g_didx[k, : len(g.div_dims)] = g.div_dims
        self.claim_meta: list[str] = []  # hostname per claim index
        self.err_by_idx: dict[int, Exception] = {}
        self.timeout_idx: set[int] = set()
        self._pack_cache: dict[tuple[bytes, bytes], tuple] = {}
        ctx = self.lib.kt_new(
            len(self.pods),
            G,
            D,
            s.U,
            self.W,
            len(s.s.nodeclaim_templates),
            gi_arr.ctypes.data_as(nat.p_i32),
            g_req.ctypes.data_as(nat.p_f64),
            g_fit.ctypes.data_as(nat.p_f64),
            g_ndim.ctypes.data_as(nat.p_i32),
            g_didx.ctypes.data_as(nat.p_i32),
            utype.ctypes.data_as(nat.p_u64),
            1 if s.nodes else 0,
            -1.0 if timeout is None else float(timeout),
        )
        if not ctx:
            raise _Fallback("native context allocation failed")
        self.ctx = ctx

    def _pack(self, mask: np.ndarray) -> np.ndarray:
        b = np.packbits(np.ascontiguousarray(mask), bitorder="little")
        out = np.zeros(self.W * 8, dtype=np.uint8)
        out[: b.size] = b
        return out.view(np.uint64)

    def add_claim(self, ti, fam, hostname, pod, gi, candidate, u_ids, rem, reusable):
        # called from _open_claim while resolving ACT_NEED_NEW_CLAIM; the
        # opening pod is the one the kernel just handed us. For open_cache-
        # shared candidate arrays (reusable), the packed mask and int32 u_ids
        # are cached per array identity: openings for the same (template,
        # group) reuse one encoding. One-shot arrays (limits in play) are
        # encoded inline — caching them could never hit.
        nat = self.nat
        self.claim_meta.append(hostname)
        if reusable:
            # value fingerprint, not id(): object ids recycle after GC, so a
            # recycled candidate array could hit a stale entry. The fingerprint
            # must cover BOTH arrays — two (template, group) openings can share
            # a candidate mask yet differ in fitting u_ids. Value keying also
            # lets value-identical openings share one encoding.
            global PACK_CACHE_HITS, PACK_CACHE_MISSES
            cache_key = (candidate.tobytes(), np.ascontiguousarray(u_ids).tobytes())
            cached = self._pack_cache.get(cache_key)
            if cached is None:
                PACK_CACHE_MISSES += 1
                mask = self._pack(candidate)
                u32 = np.ascontiguousarray(u_ids, dtype=np.int32)
                # pre-cast the stable pointers: openings for the same
                # (template, group) repeat thousands of times per pass and
                # ctypes casts are measurable at that rate; the arrays are
                # held in the tuple so their buffers can't move or recycle
                cached = (
                    mask.ctypes.data_as(nat.p_u64),
                    u32.ctypes.data_as(nat.p_i32),
                    len(u32),
                    mask,
                    u32,
                )
                self._pack_cache[cache_key] = cached
            else:
                PACK_CACHE_HITS += 1
            mask_ptr, u32_ptr, n_u = cached[0], cached[1], cached[2]
        else:
            mask = self._pack(candidate)
            u32 = np.ascontiguousarray(u_ids, dtype=np.int32)
            mask_ptr = mask.ctypes.data_as(nat.p_u64)
            u32_ptr = u32.ctypes.data_as(nat.p_i32)
            n_u = len(u32)
        remc = np.ascontiguousarray(rem, dtype=np.float64)
        self.lib.kt_add_claim(
            self.ctx,
            ti,
            fam,
            self._cur_pod_idx,
            gi,
            mask_ptr,
            u32_ptr,
            remc.ctypes.data_as(nat.p_f64),
            n_u,
        )

    def drive(self) -> None:
        nat, lib, ctx, s = self.nat, self.lib, self.ctx, self.s
        out = (nat.i64 * 8)()
        templates = s.s.nodeclaim_templates
        while True:
            act = lib.kt_run(ctx, out)
            if act == nat.ACT_DONE:
                break
            if act == nat.ACT_TIMEOUT:
                s.timed_out = True
                head = int(out[0])
                qlen = int(lib.kt_queue_len(ctx))
                tail = np.zeros(max(qlen - head, 0), dtype=np.int32)
                if tail.size:
                    lib.kt_queue_tail(ctx, head, tail.ctypes.data_as(nat.p_i32))
                for idx in tail.tolist():
                    self.timeout_idx.add(idx)
                    self.err_by_idx.setdefault(
                        idx, TimeoutError("scheduling simulation timed out")
                    )
                break
            if act == nat.ACT_NEED_TOL:
                pidx, gi, _ci, ti = int(out[0]), int(out[1]), int(out[2]), int(out[3])
                tol = Taints(templates[ti].spec.taints).tolerates_pod(
                    self.pods[pidx]
                ) is None
                s.tg_tol[(ti, gi)] = tol
                lib.kt_set_tol(ctx, ti, gi, 1 if tol else 0)
                continue
            if act == nat.ACT_NEED_JOIN:
                _pidx, gi, _ci, fam = int(out[0]), int(out[1]), int(out[2]), int(out[3])
                ent = s.fam_join.get((fam, gi))
                if ent is None:
                    ent = s._build_fam_join(fam, gi)
                if ent[0] == s._REJECT:
                    lib.kt_set_join(ctx, fam, gi, nat.JOIN_REJECT, 0, None)
                elif ent[0] == s._SAME:
                    lib.kt_set_join(ctx, fam, gi, nat.JOIN_SAME, 0, None)
                else:
                    mask = self._pack(ent[2])
                    lib.kt_set_join(
                        ctx,
                        fam,
                        gi,
                        nat.JOIN_NARROW,
                        ent[1],
                        mask.ctypes.data_as(nat.p_u64),
                    )
                continue
            if act == nat.ACT_NEED_NEW_CLAIM:
                pidx, gi = int(out[0]), int(out[1])
                pod = self.pods[pidx]
                self._cur_pod_idx = pidx
                if not templates:
                    err: Optional[Exception] = ValueError(
                        "nodepool requirements filtered out all available instance types"
                    )
                else:
                    err = s._new_claim(pod, s.groups[gi], gi)
                if err is None:
                    lib.kt_resolve(ctx, 1)
                else:
                    self.err_by_idx[pidx] = err
                    lib.kt_resolve(ctx, 2)
                continue
            if act == nat.ACT_NEED_NODES:
                pidx, gi = int(out[0]), int(out[1])
                pod = self.pods[pidx]
                placed = s._try_nodes(pod, s.groups[gi], gi)
                if s.nptr[gi] >= len(s.nodes):
                    lib.kt_set_nodes_done(ctx, gi)
                lib.kt_resolve(ctx, 1 if placed else 0)
                continue
            raise _Fallback(f"native kernel returned unknown action {act}")
        self._finish()

    def _finish(self) -> None:
        """Materialize claims and pod errors back into the _DeviceSolve."""
        nat, lib, ctx, s = self.nat, self.lib, self.ctx, self.s
        failed = np.zeros(len(self.pods), dtype=np.uint8)
        if len(self.pods):
            lib.kt_failed(ctx, failed.ctypes.data_as(nat.p_u8))
        for idx, err in self.err_by_idx.items():
            if failed[idx] or idx in self.timeout_idx:
                s.pod_errors[self.pods[idx]] = err
        # bulk export: two calls instead of 2 per claim
        sizes = (nat.i64 * 4)()
        lib.kt_export_sizes(ctx, sizes)
        n, total_u, total_m, total_g = (int(sizes[k]) for k in range(4))
        if n == 0:
            return
        info = np.zeros(n * 6, dtype=np.int64)
        words = np.zeros(n * self.W, dtype=np.uint64)
        u_ids_flat = np.zeros(max(total_u, 1), dtype=np.int32)
        members_flat = np.zeros(max(total_m, 1), dtype=np.int32)
        groups_flat = np.zeros(max(total_g, 1), dtype=np.int32)
        counts_flat = np.zeros(max(total_g, 1), dtype=np.int32)
        lib.kt_export(
            ctx,
            info.ctypes.data_as(nat.p_i64),
            words.ctypes.data_as(nat.p_u64),
            u_ids_flat.ctypes.data_as(nat.p_i32),
            members_flat.ctypes.data_as(nat.p_i32),
            groups_flat.ctypes.data_as(nat.p_i32),
            counts_flat.ctypes.data_as(nat.p_i32),
        )
        info = info.reshape(n, 6)
        all_masks = (
            np.unpackbits(
                words.reshape(n, self.W).view(np.uint8), axis=1, bitorder="little"
            )[:, : s.I]
            .astype(bool)
        )
        ui = mi = gi2 = 0
        for ci in range(n):
            ti, fam, count, M, n_members, n_groups = (int(v) for v in info[ci])
            c = _Claim(
                ti,
                fam,
                self.claim_meta[ci],
                all_masks[ci],
                u_ids_flat[ui : ui + M].astype(np.int64),
                np.zeros((0, s.D)),
                0,
            )
            ui += M
            c.count = count
            c.members = [self.pods[i] for i in members_flat[mi : mi + n_members].tolist()]
            mi += n_members
            c.group_counts = {
                int(g): int(k)
                for g, k in zip(
                    groups_flat[gi2 : gi2 + n_groups].tolist(),
                    counts_flat[gi2 : gi2 + n_groups].tolist(),
                )
            }
            gi2 += n_groups
            s.claims.append(c)

    def close(self) -> None:
        if self.ctx:
            self.lib.kt_free(self.ctx)
            self.ctx = None


class _DeviceSolve:
    def __init__(self, scheduler, pods: Sequence[Pod]):
        self.s = scheduler
        self.engine: "CatalogEngine" = scheduler.engine
        self.pods = pods
        e = self.engine
        self.dims = e.resource_dims
        self.D = len(self.dims)
        self.I = e.num_instances
        self.alloc_f = e.allocatable  # [I, D] float64
        self.cap_f = e.capacity  # [I, D] float64
        # Catalogs repeat allocatable vectors (size families × zones); fit
        # checks collapse to the unique rows, shrinking every claim's
        # headroom matrix ~I/U-fold.
        self.uniq_alloc, self.uid_of_type = np.unique(
            self.alloc_f, axis=0, return_inverse=True
        )
        self.U = self.uniq_alloc.shape[0]
        self.groups: list[_Group] = []
        self.claims: list[_Claim] = []
        self.nodes = _LazyNodes(scheduler.existing_nodes)
        self.seq = 0  # bucket-entry counter for the stable-sort order model
        # joint requirement-set masks: frozenset(row ids) -> (compat, offer).
        # Shared on the ENGINE across solves: steady-state provisioner
        # passes re-derive identical joints, and masks are pure content
        # functions (rows are interned per engine). LRU-bounded: _joint_masks
        # reinserts on every hit, so eviction sheds only cold entries.
        _evict_lru(e.solver_joint_cache, _ENGINE_CACHE_CAP)
        self.joint_cache = e.solver_joint_cache
        # requirement-set families: frozenset(row ids) -> id, plus the
        # canonical hostname-free Requirements per id and the memoized join
        # transitions (family, group) -> reject | same | narrow
        self.fam_ids: dict[frozenset, int] = {}
        self.fam_rows: list[frozenset] = []
        self.fam_reqs: list[Requirements] = []
        self.fam_join: dict[tuple[int, int], tuple] = {}
        self.remaining_resources = {
            name: dict(rl) for name, rl in scheduler.remaining_resources.items()
        }
        self.limits_version = 0
        # per-pool limit-tracking versions: bumped by _subtract_max so the
        # limits mask and claim-opening caches invalidate only for the pool
        # whose remaining budget actually moved (8-pool solves would
        # otherwise recompute every open from scratch)
        self.pool_limits_ver: dict[str, int] = {}
        self._limits_mask_cache: dict[str, tuple[int, np.ndarray]] = {}
        # (ti, pool_ver) -> True (types remain) | the cached exhaustion error
        self._limits_any: dict[tuple[int, int], object] = {}
        # (ti, gi, id(limits_mask)) ->
        # (candidate, row_sel, u_ids, min_specs, min_relaxed, min_msg, mask ref)
        self._limited_open_cache: dict[tuple, tuple] = {}
        # per-group state
        self.gheaps: list[list] = []
        self.gsynced: list[int] = []
        self.nptr: list[int] = []
        # gi -> (limits_version, error, staged explanation funnel or None)
        self.gnewclaim_err: dict[int, tuple[int, Exception, Optional[list]]] = {}
        # (ti, gi) -> memoized LIMITLESS claim-opening data
        # (fam, candidate0, u_ids0, rem0_fit0, min_specs, min_relaxed) or
        # (-1,...) = permanent error; active nodepool limits are applied per
        # open as a type-mask AND over the cached entry (_new_claim)
        self.open_cache: dict[tuple[int, int], tuple] = {}
        self._open_errs: dict[tuple[int, int], Exception] = {}
        # per-(template, group) static caches
        self.tg_tol: dict[tuple[int, int], bool] = {}
        self.tg_compat: dict[tuple[int, int], Optional[tuple]] = {}
        self.pod_errors: dict[Pod, Exception] = {}
        self.timed_out = False
        self._native: Optional[_NativeDriver] = None
        # deferred-claim machinery (enabled by the topo driver when no
        # per-join row reads are needed; see _Claim.defer)
        self._defer_ok = False
        self._pareto_cache: dict[int, tuple] = {}
        # per-claim-index HostPortUsage; populated only by the topo driver
        # when host ports are in play (plain solves gate ports shapes out)
        self._claim_hp: dict[int, HostPortUsage] = {}
        # min_active is set for real in _prepare_templates; abort() may run
        # before that (e.g. an ineligible shape found during grouping)
        self.min_active = False
        from karpenter_tpu_torch.scheduler.scheduler import MIN_VALUES_POLICY_STRICT

        self.best_effort = scheduler.min_values_policy != MIN_VALUES_POLICY_STRICT
        self._saved_rm: Optional[tuple] = None
        # reserved-capacity flags are needed during grouping already (strict
        # mode makes every shape volatile on the topo driver)
        self.res_active = bool(
            scheduler.reserved_capacity_enabled
            and getattr(e, "_kt_has_reserved", False)
        )
        self.strict_res = _strict_reserved(scheduler)
        # strict-mode paths evaluate reservations PRE-commit (the evaluation
        # can raise at the host's can_add position) and stash the result
        # here for the commit hook; fallback mode leaves it None (computed
        # post-commit, identical by construction)
        self._pending_reserved: Optional[list] = None

    def abort(self) -> None:
        """Undo external state mutations before a host fallback. The plain
        solver mutates nothing outside itself until emit EXCEPT reservation
        bookkeeping; the topo driver overrides this to additionally restore
        topology counts/ownership."""
        self._restore_rm()

    def _restore_rm(self) -> None:
        if self._saved_rm is not None:
            rm = self.s.reservation_manager
            reservations, capacity = self._saved_rm
            rm._reservations = {h: set(ids) for h, ids in reservations.items()}
            rm._capacity = dict(capacity)

    # -- reserved offerings (fallback mode; nodeclaim.go:166-205,324-346) ----

    def _reserved_eval(
        self,
        hostname: str,
        reqs: Requirements,
        final_types: np.ndarray,
        fam: Optional[int] = None,
        current_reserved: Sequence = (),
    ) -> list:
        """The host's _offerings_to_reserve (nodeclaim.go:166-205) over a
        surviving-type mask: reserved offerings compatible with `reqs` that
        can still be reserved for `hostname`, in catalog order. In STRICT
        mode this raises the host's ReservedOfferingErrors — compatible but
        unreservable, or updated constraints stripping every held option."""
        rm = self.s.reservation_manager
        has_compatible = False
        out = []
        for i, offs in self.res_offs:
            if not final_types[i]:
                continue
            for oi, o in enumerate(offs):
                if not o.available:
                    continue
                if fam is not None:
                    key = (fam, i, oi)
                    ok = self._res_compat.get(key)
                    if ok is None:
                        ok = reqs.is_compatible(
                            o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                        )
                        self._res_compat[key] = ok
                else:
                    ok = reqs.is_compatible(
                        o.requirements, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                    )
                if not ok:
                    continue
                has_compatible = True
                if rm.can_reserve(hostname, o):
                    out.append(o)
        if self.strict_res:
            from karpenter_tpu_torch.scheduler.nodeclaim import (
                raise_strict_reserved_errors,
            )

            raise_strict_reserved_errors(has_compatible, out, current_reserved)
        return out

    def _final_types(self, type_mask: np.ndarray, u_ids: np.ndarray) -> np.ndarray:
        surv_u = np.zeros(self.U, dtype=bool)
        surv_u[u_ids] = True
        return type_mask & surv_u[self.uid_of_type]

    def _apply_reserved(self, c: "_Claim", updated: Optional[list] = None) -> None:
        """NodeClaim.add's reservation tail: reserve the fresh set, release
        ids that dropped out (nodeclaim.go:337-346). Strict callers pass the
        pre-commit-evaluated list (the evaluation may raise and must run at
        the host's can_add position); fallback mode computes it here, on the
        post-commit state — identical by construction."""
        if updated is None:
            updated = self._reserved_eval(
                c.hostname,
                self.fam_reqs[c.fam],
                self._final_types(c.type_mask, c.u_ids),
                fam=c.fam,
            )
        rm = self.s.reservation_manager
        rm.reserve(c.hostname, *updated)
        updated_ids = {o.reservation_id for o in updated}
        for o in c.reserved:
            if o.reservation_id not in updated_ids:
                rm.release(c.hostname, o)
        c.reserved = updated

    def _materialize(self, c: "_Claim") -> None:
        """Collapse a claim's deferred joins into the standard rem/u_ids
        narrowing. Exact: a row survives the iterative per-join pruning iff
        it fits the accumulated usage (the prune criterion telescopes dim by
        dim — usage only grows), so one vectorized pass reproduces the whole
        sequence."""
        extra = c.defer[1]
        c.defer = None
        if any(extra):
            cur = c.rem - np.asarray(extra)
            keep = (cur >= -_EPS).all(axis=1)
            if keep.all():
                c.rem = cur
            else:
                c.rem = cur[keep]
                c.u_ids = c.u_ids[keep]

    def _pareto_for(self, rem: np.ndarray) -> list:
        """Pareto-maximal rows of an open-time headroom matrix as Python
        lists — any-row-fits is equivalent to any-PARETO-row-fits, and the
        maximal set is tiny. Cached by matrix identity: memoized openings
        share one matrix across thousands of claims."""
        cache = self._pareto_cache
        hit = cache.get(id(rem))
        if hit is not None:
            return hit[0]
        rows = rem.tolist()
        pareto: list = []
        for r in sorted(rows, key=sum, reverse=True):
            if not any(
                all(p[d] >= r[d] for d in range(len(r))) for p in pareto
            ):
                pareto.append(r)
        cache[id(rem)] = (pareto, rem)  # hold rem so its id can't recycle
        return pareto

    def _order_hook_add(self, ci: int) -> None:
        """Claim-order observer: a claim was opened (index ci). The topo
        driver maintains an incremental host-scan order; a no-op here."""

    def _order_hook_move(self, ci: int, old_key: tuple, new_key: tuple) -> None:
        """Claim-order observer: claim ci's (count, rank, ci) key changed."""

    def _intern_fam(self, rows: frozenset, reqs: Requirements) -> int:
        """Intern a requirement row-set; `reqs` must be the hostname-free
        requirement set whose interned rows are exactly `rows`."""
        fam = self.fam_ids.get(rows)
        if fam is None:
            fam = len(self.fam_rows)
            self.fam_ids[rows] = fam
            self.fam_rows.append(rows)
            self.fam_reqs.append(reqs)
        return fam

    # -- encoding ------------------------------------------------------------

    def _group_pods(self) -> Optional[np.ndarray]:
        """Collapse pods into value-identical shape groups; PodData is
        computed ONCE per group (the per-pod host parse is the single
        biggest cost at 50k pods). Returns the per-pod group-index array, or
        None when a shape fails the per-group eligibility gates (→ host
        path). Group numbering follows interned-signature order — decisions
        never depend on it (only pod queue order matters)."""
        s, dims = self.s, self.dims
        pods = self.pods
        # the spec signature is immutable alongside the spec; pods resolve
        # across provisioner passes, so its interned id is cached on the
        # object (invalidated at spec mutation sites as _kt_sig)
        try:
            sigs = [p._kt_sig for p in pods]
        except AttributeError:
            sigs = []
            for pod in pods:
                sig = getattr(pod, "_kt_sig", None)
                if sig is None:
                    raw = _raw_sig(pod)
                    sig = _SIG_IDS.get(raw)
                    if sig is None:
                        if len(_SIG_IDS) >= _SIG_CAP:
                            _SIG_IDS.clear()
                        sig = next(_SIG_NEXT)
                        _SIG_IDS[raw] = sig
                    try:
                        pod._kt_sig = sig
                    except Exception:  # noqa: BLE001 — slotted/frozen pod
                        pass
                sigs.append(sig)
        _, first_idx, inverse, counts = np.unique(
            np.asarray(sigs, dtype=np.int64),
            return_index=True,
            return_inverse=True,
            return_counts=True,
        )
        for k, fi in enumerate(first_idx):
            pod = pods[int(fi)]
            if not _group_eligible(pod):
                return None
            s.update_cached_pod_data(pod)
            data = s.cached_pod_data[pod.metadata.uid]
            if any(name not in dims for name in data.requests):
                return None
            group = _Group(data, dims)
            if group.has_hostname:
                # per-claim hostname placeholders defeat family sharing;
                # hostname-pinned pods are rare — host path
                return None
            group.n_pods = int(counts[k])
            self.groups.append(group)
        G = len(self.groups)
        self.gheaps = [[] for _ in range(G)]
        self.gsynced = [0] * G
        self.nptr = [0] * G
        return inverse.astype(np.int32)

    # single-slot: steady-state passes re-solve the latest batch; holding
    # more would pin old pod sets in memory for the process lifetime
    _ORDER_CACHE: dict = {}

    def _order(self, gi_arr: np.ndarray) -> np.ndarray:
        """Exact host queue order (queue.go:72-108): cpu desc, mem desc,
        creation timestamp, uid. Vectorized via lexsort (numpy string
        comparison is code-point order — identical to Python's). Returns
        the permutation of pod indices.

        The permutation is memoized per (pod identities, shape signatures,
        group sort keys): steady-state provisioner passes re-solve the same
        pod set, whose uids/timestamps are immutable and whose effective
        shapes are pinned by the signature bytes in the key."""
        groups = self.groups
        pods = self.pods
        key = None
        try:
            key = (
                tuple(map(id, pods)),
                gi_arr.tobytes(),
                tuple((g.sort_cpu, g.sort_mem) for g in groups),
            )
            hit = self._ORDER_CACHE.get(key)
            if hit is not None:
                return hit[0]
        except (TypeError, ValueError):
            pass
        order = self._order_compute(gi_arr)
        if key is not None:
            self._ORDER_CACHE.clear()
            # hold the pods so their ids can't recycle while cached
            self._ORDER_CACHE[key] = (order, list(pods))
        return order

    def _order_compute(self, gi_arr: np.ndarray) -> np.ndarray:
        groups = self.groups
        pods = self.pods
        try:
            cpu = np.array([g.sort_cpu for g in groups])[gi_arr]
            mem = np.array([g.sort_mem for g in groups])[gi_arr]
            ts = np.fromiter(
                (p.metadata.creation_timestamp for p in pods),
                dtype=np.float64,
                count=len(pods),
            )
            uid = np.array([p.metadata.uid for p in pods])
            return np.lexsort((uid, ts, -mem, -cpu))
        except (TypeError, ValueError):
            return np.array(
                sorted(
                    range(len(pods)),
                    key=lambda i: (
                        -groups[gi_arr[i]].sort_cpu,
                        -groups[gi_arr[i]].sort_mem,
                        pods[i].metadata.creation_timestamp,
                        pods[i].metadata.uid,
                    ),
                ),
                dtype=np.int64,
            )

    def _rows_sans_hostname(self, reqs: Requirements) -> frozenset:
        rid = self.engine.row_id
        return frozenset(
            rid(r) for r in reqs if r.key != wk.LABEL_HOSTNAME
        )

    @staticmethod
    def _sans_hostname(reqs: Requirements) -> Requirements:
        """Canonical hostname-free copy — the form every engine-level cache
        (solver_fam_trans, family interning) keys on; all canonicalization
        sites must share this ONE definition."""
        return Requirements(*(r for r in reqs if r.key != wk.LABEL_HOSTNAME))

    def _prepare_templates(self) -> None:
        """Template masks/overheads + the batched device sweep over all
        compatible (template x group) joint requirement sets — the
        batched device part of the solve (SURVEY.md §7 step 2)."""
        s, e = self.s, self.engine
        T = len(s.nodeclaim_templates)
        G = len(self.groups)
        self.tmpl_mask = np.zeros((T, self.I), dtype=bool)
        self.tmpl_options: list[list] = []
        self.usage0_f = np.zeros((T, self.D), dtype=np.float64)
        # minValues specs per template: only template rows carry minValues
        # (pods can't set it; joint merges keep the template's via max-merge),
        # so the per-claim check is fully determined by (ti, surviving types)
        self.tmpl_min: list[list[tuple[str, int]]] = [
            [
                (r.key, r.min_values)
                for r in s.nodeclaim_templates[ti].requirements
                if r.min_values is not None
            ]
            for ti in range(T)
        ]
        self.min_active = any(self.tmpl_min)
        # reserved-capacity bookkeeping: per-type reserved offerings in
        # catalog order + a snapshot of the ReservationManager so a
        # fallback abort leaves the host loop uncorrupted state
        if self.res_active:
            self.res_offs: list[tuple[int, list]] = []
            for i, it in enumerate(e.instance_types):
                if it.has_reserved_offerings:
                    self.res_offs.append(
                        (
                            i,
                            [
                                o
                                for o in it.offerings
                                if o.capacity_type == wk.CAPACITY_TYPE_RESERVED
                            ],
                        )
                    )
            self._res_compat: dict[tuple[int, int, int], bool] = {}
            rm = s.reservation_manager
            self._saved_rm = (
                {h: set(ids) for h, ids in rm._reservations.items()},
                dict(rm._capacity),
            )
        index = {id(it): i for i, it in enumerate(e.instance_types)}
        name_index = {it.name: i for i, it in enumerate(e.instance_types)}
        self.opt_index: list[list[int]] = []
        for g in self.groups:
            g.rowset = self._rows_sans_hostname(g.reqs)
        for ti, nct in enumerate(s.nodeclaim_templates):
            idxs = []
            for it in nct.instance_type_options:
                i = index.get(id(it))
                if i is None:
                    i = name_index.get(it.name)
                if i is None:
                    raise _Fallback("template option missing from engine catalog")
                idxs.append(i)
                self.tmpl_mask[ti, i] = True
            self.opt_index.append(idxs)
            self.tmpl_options.append(list(nct.instance_type_options))
            for name, v in s.daemon_overhead[nct].items():
                self.usage0_f[ti, self.dims[name]] = v
        # Joint (template x group) requirement sets, evaluated in ONE batched
        # device sweep — the [T*G, I] membership-matmul cube. Shared with
        # solverd's coalescer: prime_joint_masks is the single sweep
        # implementation, _joint_pairs the single domain enumeration.
        pairs = self._joint_pairs()
        if pairs is not None:
            prime_joint_masks(e, pairs)

    def _joint_pairs(self) -> Optional[list[tuple]]:
        """All compatible (template x group) joint (rows, Requirements)
        pairs — this solve's sweep domain. None for degenerate solves with a
        huge distinct-shape count, which fall back to lazy per-pair host
        evaluation (still exact) to bound the batch."""
        T = len(self.s.nodeclaim_templates)
        G = len(self.groups)
        if T * G > 8192:
            return None
        out: list[tuple] = []
        for ti in range(T):
            for gi in range(G):
                tg = self._tg(ti, gi)
                if tg is not None:
                    joint, rows = tg
                    out.append((rows, joint))
        return out

    _MISSING = object()

    def _tg(self, ti: int, gi: int):
        """(joint Requirements, engine row-set) for template x group, or None
        when the template's requirements reject the group."""
        key = (ti, gi)
        got = self.tg_compat.get(key, self._MISSING)
        if got is self._MISSING:
            nct = self.s.nodeclaim_templates[ti]
            g = self.groups[gi]
            err = nct.requirements.compatible(
                g.reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            )
            if err is not None:
                got = None
            else:
                joint = Requirements(*nct.requirements.values())
                joint.add(*g.reqs.values())
                got = (joint, self._rows_sans_hostname(joint))
            self.tg_compat[key] = got
        return got

    # -- joint masks ---------------------------------------------------------

    def _joint_masks(self, rows: frozenset, reqs: Requirements) -> tuple:
        global JOINT_CACHE_HITS, JOINT_CACHE_MISSES
        cache = self.joint_cache
        got = cache.get(rows)
        if got is None:
            JOINT_CACHE_MISSES += 1
            keys = [r.key for r in reqs if r.key != wk.LABEL_HOSTNAME]
            got = self.engine.masks_for_rows(list(rows), keys)
        else:
            JOINT_CACHE_HITS += 1
            # LRU touch: reinsertion moves the entry to the recency tail so
            # _evict_lru sheds cold entries first
            del cache[rows]
        cache[rows] = got
        return got

    # -- existing nodes (addToExistingNode, scheduler.go:451-473) ------------

    def _try_nodes(self, pod: Pod, g: _Group, gi: int) -> bool:
        nodes = self.nodes
        j = self.nptr[gi]
        N = len(nodes)
        while j < N:
            nd = nodes[j]
            tol = nd.gtol.get(gi)
            if tol is None:
                tol = Taints(nd.en.cached_taints).tolerates_pod(pod) is None
                nd.gtol[gi] = tol
            if not tol:
                j += 1
                continue
            cc = nd.gcompat.get(gi)
            if cc is None or cc[0] != nd.version:
                ok = nd.reqs.compatible(g.reqs) is None
                nd.gcompat[gi] = (nd.version, ok)
            else:
                ok = cc[1]
            if not ok:
                # requirements only narrow: permanently incompatible
                j += 1
                continue
            kc = nd.gcap.get(gi)
            if kc is None or kc[0] != nd.usage_ver:
                k = self._node_capacity(nd, g)
            else:
                k = kc[1]
            if k <= 0:
                # remaining resources only shrink: permanently full
                j += 1
                continue
            # join
            self.nptr[gi] = j
            self._joined_node = nd
            nd.joined.append(pod)
            nd.remaining = res.subtract(nd.remaining, g.requests)
            narrowed = any(
                not nd.reqs.has(r.key) or nd.reqs.get(r.key) != r for r in g.reqs
            )
            if narrowed:
                joint = Requirements(*nd.reqs.values())
                joint.add(*g.reqs.values())
                nd.reqs = joint
                nd.version += 1
            nd.usage_ver += 1
            nd.gcap[gi] = (nd.usage_ver, k - 1)
            return True
        self.nptr[gi] = j
        return False

    def _node_capacity(self, nd: _Node, g: _Group) -> int:
        k = _BIG
        remaining = nd.remaining
        for name, v in g.requests.items():
            if v <= 0:
                continue
            have = remaining.get(name, 0.0)
            k = min(k, int((have + _EPS) // v))
            if k <= 0:
                return 0
        return int(k)

    # -- in-flight claims (addToInflightNode, scheduler.go:510-543) ----------

    def _try_claims(self, pod: Pod, g: _Group, gi: int) -> bool:
        claims = self.claims
        heap = self.gheaps[gi]
        synced = self.gsynced[gi]
        if synced < len(claims):
            for ci in range(synced, len(claims)):
                c = claims[ci]
                heapq.heappush(heap, (c.count, c.rank, ci))
            self.gsynced[gi] = len(claims)
        req_f = g.req_f
        fit_floor = g.fit_floor  # req_f - eps, precomputed
        while heap:
            count, rank, ci = heap[0]
            c = claims[ci]
            if c.defer is not None:
                self._materialize(c)
            if gi in c.gdrop:
                heapq.heappop(heap)
                continue
            if c.count != count or c.rank != rank:
                heapq.heapreplace(heap, (c.count, c.rank, ci))
                continue
            if gi in c.gknown:
                # steady state: requirements already subsumed; one small
                # compare against the remaining-headroom matrix decides
                fitrows = (c.rem >= fit_floor).all(axis=1)
                if not fitrows.any():
                    c.gdrop.add(gi)  # usage only grows: permanently full
                    heapq.heappop(heap)
                    continue
                # a fit-shrunk option set can newly violate minValues (the
                # host re-filters on every can_add); unchanged sets passed
                # when the claim last changed
                if (
                    self.min_active
                    and not fitrows.all()
                    and not self._min_join_ok(c, c.u_ids[fitrows])
                ):
                    c.gdrop.add(gi)  # diversity only shrinks: permanent
                    heapq.heappop(heap)
                    continue
            else:
                fitrows = self._try_first_join(c, pod, g, gi)
                if fitrows is None:
                    c.gdrop.add(gi)  # all rejection reasons are monotone
                    heapq.heappop(heap)
                    continue
            # join: usage grows by req_f; rows that no longer fit the NEW
            # usage (exactly the rows failing this fit check) die forever
            if fitrows.all():
                c.rem -= req_f
            else:
                c.rem = c.rem[fitrows] - req_f
                c.u_ids = c.u_ids[fitrows]
            c.count = count + 1
            self.seq += 1
            c.rank = -self.seq
            c.members.append(pod)
            c.group_counts[gi] = c.group_counts.get(gi, 0) + 1
            heapq.heapreplace(heap, (c.count, c.rank, ci))
            self._joined = c
            self._order_hook_move(ci, (count, rank, ci), (c.count, c.rank, ci))
            if self.res_active:
                self._apply_reserved(c, self._pending_reserved)
                self._pending_reserved = None
            return True
        return False

    _REJECT, _SAME, _NARROW = 0, 1, 2

    def _try_first_join(self, c: _Claim, pod: Pod, g: _Group, gi: int):
        """First join of group g onto claim c: the full NodeClaim.can_add
        gate sequence (nodeclaim.go:114-163). Returns the fit-row mask over
        the claim's (possibly narrowed) headroom matrix, or None to reject
        permanently. Commits requirement narrowing on success.

        The requirement algebra — compatibility, joint construction, joint
        masks — depends only on (claim requirement family, group), so its
        outcome is memoized as a family TRANSITION; per-claim work is a few
        small-array ops. Hostname placeholders never participate: groups
        constraining hostname are gated to the host path."""
        tol = self.tg_tol.get((c.ti, gi))
        if tol is None:
            nct = self.s.nodeclaim_templates[c.ti]
            tol = Taints(nct.spec.taints).tolerates_pod(pod) is None
            self.tg_tol[(c.ti, gi)] = tol
        if not tol:
            return None
        ent = self.fam_join.get((c.fam, gi))
        if ent is None:
            ent = self._build_fam_join(c.fam, gi)
        kind = ent[0]
        if kind == self._REJECT:
            return None
        if kind == self._NARROW:
            new_mask = c.type_mask & ent[2]
            # unique-alloc rows that still have a surviving type
            surv_u = np.zeros(self.U, dtype=bool)
            surv_u[self.uid_of_type[new_mask]] = True
            keep = surv_u[c.u_ids]
            fitrows = keep & (c.rem >= g.fit_floor).all(axis=1)
            if not fitrows.any():
                return None
            if self.min_active and not self._min_join_ok(
                c, c.u_ids[fitrows], new_mask
            ):
                return None
            # commit the requirement-level narrowing (host narrows options on
            # every successful Add with the joint set)
            c.type_mask = new_mask
            c.rem = c.rem[keep]
            c.u_ids = c.u_ids[keep]
            c.fam = ent[1]
            c.gknown.add(gi)
            return fitrows[keep]
        fitrows = (c.rem >= g.fit_floor).all(axis=1)
        if not fitrows.any():
            return None
        if (
            self.min_active
            and not fitrows.all()
            and not self._min_join_ok(c, c.u_ids[fitrows])
        ):
            return None
        c.gknown.add(gi)
        return fitrows

    def _build_fam_join(self, fam: int, gi: int) -> tuple:
        """Memoized family transition for group gi joining a claim of family
        fam: reject (incompatible), same (joint row-set unchanged — adding
        the group narrows nothing), or narrow (new family id + the combined
        compat∧offering mask to AND into the claim's options).

        The requirement algebra is a pure function of the two row-sets, so
        its outcome is cached on the ENGINE across solves (steady-state
        passes re-derive identical transitions); only the per-solve family
        id interning and the mask AND run per solve."""
        g = self.groups[gi]
        base_rows = self.fam_rows[fam]
        ckey = (base_rows, g.rowset)
        cached = self.engine.solver_fam_trans.get(ckey)
        if cached is None:
            base = self.fam_reqs[fam]
            if base.compatible(g.reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS) is not None:
                cached = (self._REJECT, None, None)
            elif g.rowset <= base_rows:
                # every group row IS the claim's row for that key
                cached = (self._SAME, None, None)
            else:
                joint = Requirements(*base.values())
                joint.add(*g.reqs.values())
                rows = self._rows_sans_hostname(joint)
                if rows == base_rows:
                    cached = (self._SAME, None, None)
                else:
                    # canonical = hostname-free: the cache key strips
                    # hostname, so two groups differing only in a hostname
                    # pin share this entry — the claim's own placeholder row
                    # is re-added by the consumers that need it. Shared
                    # read-only across solves — callers copy.
                    cached = (self._NARROW, rows, self._sans_hostname(joint))
            _evict_lru(self.engine.solver_fam_trans, _ENGINE_CACHE_CAP)
            self.engine.solver_fam_trans[ckey] = cached
        else:
            # LRU touch (see _evict_lru): keep steady-state transitions warm
            del self.engine.solver_fam_trans[ckey]
            self.engine.solver_fam_trans[ckey] = cached
        kind, rows, joint = cached
        if kind == self._NARROW:
            compat_v, offer_v = self._joint_masks(rows, joint)
            new_fam = self._intern_fam(rows, joint)
            # trailing joint: the merged pre-topology requirement set,
            # reused by the topo driver (never mutated — callers copy)
            ent = (self._NARROW, new_fam, compat_v & offer_v, joint)
        else:
            ent = (kind,)
        self.fam_join[(fam, gi)] = ent
        return ent

    # -- new claims (addToNewNodeClaim, scheduler.go:478-556) ----------------

    def _ensure_open_entry(self, ti: int, gi: int) -> tuple:
        """Memoized LIMITLESS opening per (ti, gi): candidate set, fitting
        unique-alloc rows, headroom matrix, and the no-limits minValues
        outcome. Limits are applied per open as a cheap type-mask AND —
        narrowing types never changes a surviving row's headroom, so the
        limited open is a row-subset of the limitless one. Entries with
        fam < 0 are permanent failures (error stashed in _open_errs).
        Callers must have checked `_tg(ti, gi) is not None`. Shared by the
        host walk's _new_claim and the fused builder's opening tables."""
        okey = (ti, gi)
        entry = self.open_cache.get(okey)
        if entry is not None:
            return entry
        g = self.groups[gi]
        joint_tg, rows = self._tg(ti, gi)
        compat_v, offer_v = self._joint_masks(rows, joint_tg)
        base = self.tmpl_mask[ti]
        candidate0 = base & compat_v & offer_v
        cand_u = np.unique(self.uid_of_type[candidate0])
        rem0 = self.uniq_alloc[cand_u] - (self.usage0_f[ti] + g.req_f)
        fitrows = (rem0 >= -_EPS).all(axis=1)
        if not fitrows.any():
            # no limits will ever fix an empty limitless set
            err = self._filter_error(base, compat_v, offer_v, ti, g)
            self.open_cache[okey] = entry = (-1, None, None, None, None, False)
            self._open_errs[okey] = err
            return entry
        min_specs0, min_relaxed0, msg = self.tmpl_min[ti], False, None
        if self.min_active and self.tmpl_min[ti]:
            surv_u = np.zeros(self.U, dtype=bool)
            surv_u[cand_u[fitrows]] = True
            min_specs0, min_relaxed0, msg = self._min_open(
                ti, candidate0 & surv_u[self.uid_of_type]
            )
        if msg is not None:
            # strict-policy failure on the FULL set is permanent
            err = self._filter_error(base, compat_v, offer_v, ti, g)
            err.min_values_incompatible = msg
            self.open_cache[okey] = entry = (-1, None, None, None, None, False)
            self._open_errs[okey] = err
            return entry
        fam = self._intern_fam(rows, joint_tg)
        self.open_cache[okey] = entry = (
            fam, candidate0, cand_u[fitrows], rem0[fitrows],
            min_specs0, min_relaxed0,
        )
        return entry

    def _new_claim(self, pod: Pod, g: _Group, gi: int) -> Optional[Exception]:
        cached = self.gnewclaim_err.get(gi)
        if cached is not None and cached[0] == self.limits_version:
            if cached[2] is not None:
                # every pod of the group shares the cached diagnosis, but
                # each stages its OWN funnel (commit is keyed by pod uid)
                explmod.recorder().note_funnel(pod.metadata.uid, cached[2])
            return cached[1]
        s = self.s
        # errs carries (nodepool, error): the pool attribution feeds the
        # explanation funnel; the joined message is unchanged
        errs: list[tuple[str, Exception]] = []
        for ti, nct in enumerate(s.nodeclaim_templates):
            remaining = self.remaining_resources.get(nct.nodepool_name)
            limits_mask = None
            if remaining:
                limits_mask = self._limits_mask(nct.nodepool_name, remaining)
                # exhaustion check cached per (template, pool version): an
                # exhausted pool costs one dict hit per scan, not an array
                # reduction + fresh exception
                akey = (ti, self.pool_limits_ver.get(nct.nodepool_name, 0))
                hit = self._limits_any.get(akey)
                if hit is None:
                    hit = self._limits_any[akey] = (
                        bool((limits_mask & self.tmpl_mask[ti]).any())
                        or ValueError(
                            f"all available instance types exceed limits for "
                            f"nodepool {nct.nodepool_name!r}"
                        )
                    )
                if hit is not True:
                    errs.append((nct.nodepool_name, hit))
                    continue
            tol = self.tg_tol.get((ti, gi))
            if tol is None:
                terr = Taints(nct.spec.taints).tolerates_pod(pod)
                tol = terr is None
                self.tg_tol[(ti, gi)] = tol
            if not tol:
                errs.append(
                    (
                        nct.nodepool_name,
                        ValueError(str(Taints(nct.spec.taints).tolerates_pod(pod))),
                    )
                )
                continue
            tg = self._tg(ti, gi)
            if tg is None:
                errs.append(
                    (
                        nct.nodepool_name,
                        ValueError(
                            "incompatible requirements, "
                            + str(
                                nct.requirements.compatible(
                                    g.reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                                )
                            )
                        ),
                    )
                )
                continue
            entry = self._ensure_open_entry(ti, gi)
            fam, candidate0, u_ids0, rem0_fit0, min_specs, min_relaxed = entry
            okey = (ti, gi)
            if fam < 0:
                if limits_mask is None:
                    errs.append((nct.nodepool_name, self._open_errs[okey]))
                else:
                    # host diagnostics are over the LIMITED base; a limited
                    # set is a subset of the failed limitless one, so it
                    # still fails — recompute only the message bits
                    errs.append(
                        (
                            nct.nodepool_name,
                            self._limited_open_error(ti, gi, g, limits_mask),
                        )
                    )
                continue
            if limits_mask is None:
                self._open_claim(
                    ti, fam, pod, gi, candidate0, u_ids0, rem0_fit0.copy(),
                    reusable=True, min_specs=min_specs, min_relaxed=min_relaxed,
                )
                return None
            # derived limited opening, cached per (entry, mask identity):
            # the mask object is stable while the pool's budget stays
            # within one capacity threshold (see _limits_mask), so most
            # opens of a limited pool reuse one derived set — and the
            # arrays stay alive here, keeping native packings id-safe
            dkey = (ti, gi, id(limits_mask))
            derived = self._limited_open_cache.get(dkey)
            if derived is None:
                candidate = candidate0 & limits_mask
                live = np.zeros(self.U, dtype=bool)
                live[self.uid_of_type[candidate]] = True
                sel = live[u_ids0]
                u_ids = u_ids0[sel]
                # the minValues gate is fully determined by the derived set —
                # evaluate once per dkey, not per open
                mspecs, mrelax, mmsg = min_specs, min_relaxed, None
                if u_ids.size and self.min_active and self.tmpl_min[ti]:
                    surv_u = np.zeros(self.U, dtype=bool)
                    surv_u[u_ids] = True
                    mspecs, mrelax, mmsg = self._min_open(
                        ti, candidate & surv_u[self.uid_of_type]
                    )
                derived = (candidate, sel, u_ids, mspecs, mrelax, mmsg, limits_mask)
                self._limited_open_cache[dkey] = derived
            candidate, sel, u_ids, min_specs, min_relaxed, min_msg, _alive = derived
            if u_ids.size == 0:
                # limited set empty: recompute the host's exact diagnostics
                joint_tg, rows = tg
                compat_v, offer_v = self._joint_masks(rows, joint_tg)
                errs.append(
                    (
                        nct.nodepool_name,
                        self._filter_error(
                            self.tmpl_mask[ti] & limits_mask, compat_v, offer_v,
                            ti, g,
                        ),
                    )
                )
                continue
            if min_msg is not None:
                joint_tg, rows = tg
                compat_v, offer_v = self._joint_masks(rows, joint_tg)
                err = self._filter_error(
                    self.tmpl_mask[ti] & limits_mask, compat_v, offer_v, ti, g
                )
                err.min_values_incompatible = min_msg
                errs.append((nct.nodepool_name, err))
                continue
            self._open_claim(
                ti,
                fam,
                pod,
                gi,
                candidate,
                u_ids,
                rem0_fit0[sel].copy(),
                reusable=True,
                min_specs=min_specs,
                min_relaxed=min_relaxed,
            )
            surv_u = np.zeros(self.U, dtype=bool)
            surv_u[u_ids] = True
            self._subtract_max(nct, candidate & surv_u[self.uid_of_type])
            return None
        if not errs:
            errs.append(("", ValueError("no nodepool can host the pod")))
        err = (
            errs[0][1]
            if len(errs) == 1
            else ValueError("; ".join(str(e) for _, e in errs))
        )
        rec = explmod.recorder()
        funnel = explmod.funnel_from(errs) if rec.enabled else None
        if funnel is not None:
            rec.note_funnel(pod.metadata.uid, funnel)
        self.gnewclaim_err[gi] = (self.limits_version, err, funnel)
        return err

    def _open_claim(
        self,
        ti: int,
        fam: int,
        pod: Pod,
        gi: int,
        candidate: np.ndarray,
        u_ids: np.ndarray,
        rem: np.ndarray,
        reusable: bool = False,
        hostname: Optional[str] = None,
        min_specs: Optional[list] = None,
        min_relaxed: bool = False,
        pareto: Optional[list] = None,
    ) -> None:
        """Register a freshly opened claim with the active driver (Python
        loop or native kernel); the opening pod is its first member.
        `reusable` marks candidate/u_ids arrays shared via open_cache (the
        native driver caches their packed encodings only then). The topo
        driver supplies `hostname` (drawn from the host scheduler's counter
        for sorted-domain-iteration parity); plain solves use the device
        counter — placeholder strings are decision-inert without topology."""
        if hostname is None:
            hostname = f"device-placeholder-{next(_placeholder_counter):04d}"
        if self._native is not None:
            self._native.add_claim(
                ti, fam, hostname, pod, gi, candidate, u_ids, rem, reusable
            )
            return
        self.seq += 1
        c = _Claim(ti, fam, hostname, candidate, u_ids, rem, self.seq)
        c.min_specs = self.tmpl_min[ti] if min_specs is None else min_specs
        c.min_relaxed = min_relaxed
        if self._defer_ok:
            c.defer = (
                pareto if pareto is not None else self._pareto_for(rem),
                [0.0] * self.D,
            )
        c.count = 1
        c.members.append(pod)
        c.group_counts[gi] = 1
        c.gknown.add(gi)
        self.claims.append(c)
        self._order_hook_add(len(self.claims) - 1)
        if self.res_active:
            self._apply_reserved(c, self._pending_reserved)
            self._pending_reserved = None

    def _limited_open_error(
        self, ti: int, gi: int, g: _Group, limits_mask: np.ndarray
    ) -> Exception:
        """Host-identical opening failure over the LIMITS-NARROWED base —
        the slow path for the rare template whose limitless opening already
        failed (the limited subset fails too; only the diagnostic bits can
        differ)."""
        joint_tg, rows = self._tg(ti, gi)
        compat_v, offer_v = self._joint_masks(rows, joint_tg)
        base = self.tmpl_mask[ti] & limits_mask
        candidate = base & compat_v & offer_v
        cand_u = np.unique(self.uid_of_type[candidate])
        rem0 = self.uniq_alloc[cand_u] - (self.usage0_f[ti] + g.req_f)
        fitrows = (rem0 >= -_EPS).all(axis=1)
        err = self._filter_error(base, compat_v, offer_v, ti, g)
        if fitrows.any() and self.min_active and self.tmpl_min[ti]:
            surv_u = np.zeros(self.U, dtype=bool)
            surv_u[cand_u[fitrows]] = True
            _, _, msg = self._min_open(ti, candidate & surv_u[self.uid_of_type])
            if msg is not None:
                err.min_values_incompatible = msg
        return err

    def _limits_mask(self, pool_name: str, remaining: dict) -> np.ndarray:
        """Types whose CAPACITY fits inside the nodepool's remaining limits
        (scheduler.go:670-686; _filter_by_remaining_resources). Cached per
        pool until _subtract_max moves that pool's budget."""
        ver = self.pool_limits_ver.get(pool_name, 0)
        hit = self._limits_mask_cache.get(pool_name)
        if hit is not None and hit[0] == ver:
            return hit[1]
        mask = np.ones(self.I, dtype=bool)
        for name, limit in remaining.items():
            d = self.dims.get(name)
            if d is None:
                if 0.0 > limit + _EPS:
                    mask[:] = False
            else:
                mask &= self.cap_f[:, d] <= limit + _EPS
        if hit is not None and np.array_equal(hit[1], mask):
            # content unchanged (budget moved without crossing a capacity
            # threshold): keep the OLD array object so identity-keyed
            # downstream caches (derived opens, native packings) stay hot
            mask = hit[1]
        self._limits_mask_cache[pool_name] = (ver, mask)
        return mask

    def _subtract_max(self, nct, types_mask: np.ndarray) -> None:
        """Pessimistic nodepool-limit tracking: subtract the max CAPACITY
        over the claim's narrowed options (scheduler.go:744-765)."""
        remaining = self.remaining_resources.get(nct.nodepool_name)
        if not remaining:
            return
        if types_mask.any():
            maxes = self.cap_f[types_mask].max(axis=0)
        else:
            maxes = np.zeros(self.D)
        self.remaining_resources[nct.nodepool_name] = {
            k: (v - maxes[self.dims[k]] if k in self.dims else v)
            for k, v in remaining.items()
        }
        self.limits_version += 1
        self.pool_limits_ver[nct.nodepool_name] = (
            self.pool_limits_ver.get(nct.nodepool_name, 0) + 1
        )

    # -- minValues (nodeclaim.go:425-436, types.go:190-224) ------------------

    def _min_counts(
        self, specs: list[tuple[str, int]], surv_types: np.ndarray
    ) -> list[tuple[str, int, int]]:
        """(key, needed, distinct type-declared value count) per spec over a
        surviving-type mask (types.go:190-224 counting)."""
        out = []
        for key, needed in specs:
            M = self.engine.value_matrix(key)
            count = int(M[:, surv_types].any(axis=1).sum()) if M.size else 0
            out.append((key, needed, count))
        return out

    def _min_fail(
        self, specs: list[tuple[str, int]], surv_types: np.ndarray
    ) -> Optional[str]:
        """The host's strict minValues gate over a surviving-type mask:
        None when every minValues key counts enough distinct type-declared
        values, else the host's error message. The host skips the check
        entirely when `remaining` is empty (satisfies_min_values returns no
        error for zero types) — callers only reach here with a non-empty
        surviving set."""
        bad = [k for k, needed, count in self._min_counts(specs, surv_types)
               if count < needed]
        if bad:
            from karpenter_tpu_torch.cloudprovider.types import min_values_error

            return min_values_error(bad)
        return None

    def _min_open(
        self, ti: int, surv_types: np.ndarray
    ) -> tuple[list[tuple[str, int]], bool, Optional[str]]:
        """MinValues at claim open: (claim specs, relaxed?, error). Strict
        policy rejects when the count falls short; BestEffort instead writes
        the spec down to the achievable count (nodeclaim.go:425-436) so the
        open always succeeds and later joins gate on the relaxed value."""
        counted = self._min_counts(self.tmpl_min[ti], surv_types)
        if not self.best_effort:
            bad = [k for k, needed, count in counted if count < needed]
            if bad:
                from karpenter_tpu_torch.cloudprovider.types import min_values_error

                return self.tmpl_min[ti], False, min_values_error(bad)
            return self.tmpl_min[ti], False, None
        specs = [(k, min(needed, count)) for k, needed, count in counted]
        relaxed = any(count < needed for _, needed, count in counted)
        return specs, relaxed, None

    def _min_join_ok(self, c: "_Claim", new_u: np.ndarray, new_mask=None) -> bool:
        """Would claim c still satisfy its (possibly open-relaxed) minValues
        after a join that leaves unique-alloc rows `new_u` (and optionally
        narrows the type mask)? Monotone: the specs are fixed at open and
        narrowing only shrinks counts, so once False for a (claim, group)
        pair it stays False — callers may reject permanently."""
        if not c.min_specs:
            return True
        mask = c.type_mask if new_mask is None else new_mask
        surv_u = np.zeros(self.U, dtype=bool)
        surv_u[new_u] = True
        return self._min_fail(c.min_specs, mask & surv_u[self.uid_of_type]) is None

    def _filter_error(
        self,
        base: np.ndarray,
        compat_v: np.ndarray,
        offer_v: np.ndarray,
        ti: int,
        g: _Group,
    ) -> InstanceTypeFilterError:
        """Host-identical three-criteria diagnostics over the limits-filtered
        option set (nodeclaim.go:247-441)."""
        fits_v = self._fits_vec(self.usage0_f[ti] + g.req_f)
        m = base
        c, f, o = compat_v[m], fits_v[m], offer_v[m]
        rec = explmod.recorder()
        if rec.enabled:
            # decode the cube's already-materialized planes into per-stage
            # elimination counts (first-failing-stage attribution) — host
            # numpy over fetched bools, zero extra device dispatches
            from karpenter_tpu_torch.ops import feasibility as feas

            rec.note_plane_counts(feas.stage_counts(feas.stage_plane_np(c, f, o)))
        err = InstanceTypeFilterError()
        err.requirements_met = bool(c.any())
        err.fits = bool(f.any())
        err.has_offering = bool(o.any())
        err.requirements_and_fits = bool((c & f & ~o).any())
        err.requirements_and_offering = bool((c & o & ~f).any())
        err.fits_and_offering = bool((f & o & ~c).any())
        return err

    def _fits_vec(self, requests_f: np.ndarray) -> np.ndarray:
        pos = np.nonzero(requests_f > 0)[0]
        if not pos.size:
            return np.ones(self.I, dtype=bool)
        return np.all(
            requests_f[pos][None, :] <= self.alloc_f[:, pos] + _EPS, axis=1
        )

    # -- main loop (Scheduler._solve, scheduler.go:346-429) ------------------

    def run(self, timeout: Optional[float]) -> None:
        gi_arr = self._group_pods()
        if gi_arr is None:
            raise _IneligibleShape("ineligible pod shape")
        self._prepare_templates()
        order = self._order(gi_arr)
        from karpenter_tpu_torch.ops import native as nat

        # The native kernel's steady-state joins run without up-calls, so
        # they can't re-run the minValues diversity gate or the per-join
        # reservation bookkeeping — those solves take the instrumented
        # Python loop (identical semantics, rare catalog shapes)
        if nat.get_lib() is not None and not self.min_active and not self.res_active:
            pods_sorted = [self.pods[i] for i in order]
            driver = _NativeDriver(
                self, pods_sorted, np.ascontiguousarray(gi_arr[order]), timeout
            )
            self._native = driver
            try:
                driver.drive()
            finally:
                driver.close()
                self._native = None
            return
        qpods = [(self.pods[i], int(gi_arr[i])) for i in order]
        head = 0
        last_len: dict[str, int] = {}
        pod_errors = self.pod_errors
        start = time.perf_counter()
        check = 0
        while head < len(qpods):
            pod, gi = qpods[head]
            if last_len.get(pod.metadata.uid) == len(qpods) - head:
                break
            check += 1
            if timeout is not None and not (check & 0x1FF):
                if time.perf_counter() - start > timeout:
                    self.timed_out = True
                    for p, _ in qpods[head:]:
                        pod_errors.setdefault(
                            p, TimeoutError("scheduling simulation timed out")
                        )
                    return
            head += 1
            g = self.groups[gi]
            if self.nodes and self._try_nodes(pod, g, gi):
                pod_errors.pop(pod, None)
                continue
            if self._try_claims(pod, g, gi):
                pod_errors.pop(pod, None)
                continue
            if not self.s.nodeclaim_templates:
                err: Exception = ValueError(
                    "nodepool requirements filtered out all available instance types"
                )
            else:
                maybe = self._new_claim(pod, g, gi)
                if maybe is None:
                    pod_errors.pop(pod, None)
                    continue
                err = maybe
            pod_errors[pod] = err
            qpods.append((pod, gi))
            last_len[pod.metadata.uid] = len(qpods) - head

    # -- output --------------------------------------------------------------

    def emit(self):
        """Materialize scheduler state: existing-node fills, nodepool limit
        tracking, and host SchedNodeClaim objects (one per claim)."""
        import copy as _copy

        from karpenter_tpu_torch.scheduler.nodeclaim import NodeClaim as SchedNodeClaim

        s = self.s
        # only touched wrappers can have joins; untouched nodes need no
        # materialization just to skip them
        for nd in self.nodes.materialized():
            if not nd.joined:
                continue
            en = nd.en
            en.pods.extend(nd.joined)
            en.remaining_resources = nd.remaining
            en.requirements = nd.reqs
        s.remaining_resources.update(self.remaining_resources)
        opt_index_arr = [np.asarray(idxs, dtype=np.int64) for idxs in self.opt_index]
        # an empty daemon HostPortUsage (the common case) needs no deepcopy
        empty_hostports = {
            nct: not s.daemon_hostports[nct] for nct in s.nodeclaim_templates
        }
        # claims sharing (template, surviving-type set) share one options
        # list — anti-affinity-heavy solves open thousands of identical
        # claims and the per-claim list build dominated emit. Downstream
        # only ever REASSIGNS instance_type_options, never mutates in place.
        options_cache: dict[tuple, list] = {}
        for ci, c in enumerate(self.claims):
            if c.defer is not None:
                self._materialize(c)
            nct = s.nodeclaim_templates[c.ti]
            tracked_hp = self._claim_hp.get(ci)
            surv_u = np.zeros(self.U, dtype=bool)
            surv_u[c.u_ids] = True
            final_types = c.type_mask & surv_u[self.uid_of_type]
            okey = (c.ti, final_types.tobytes())
            options = options_cache.get(okey)
            if options is None:
                tmpl_opts = self.tmpl_options[c.ti]
                options = [
                    tmpl_opts[j]
                    for j in np.nonzero(final_types[opt_index_arr[c.ti]])[0]
                ]
                options_cache[okey] = options
            fam_vals = self.fam_reqs[c.fam].values()
            if c.min_relaxed:
                # BestEffort wrote the claim's minValues down to the
                # achievable counts at open (nodeclaim.go:425-436). Family
                # Requirement objects are shared across claims — substitute
                # per-claim copies rather than mutating interned rows.
                # (Substitution, not add(): add() max-merges min_values.)
                relaxed_vals = dict(c.min_specs)
                out = []
                for r in fam_vals:
                    rv = relaxed_vals.get(r.key)
                    if (
                        rv is not None
                        and r.min_values is not None
                        and rv < r.min_values
                    ):
                        r = _copy.copy(r)
                        r.min_values = rv
                    out.append(r)
                fam_vals = out
            reqs = Requirements(*fam_vals)
            reqs.add(Requirement(wk.LABEL_HOSTNAME, Operator.IN, [c.hostname]))
            requests = dict(s.daemon_overhead[nct])
            for gi, count in c.group_counts.items():
                g = self.groups[gi]
                requests = res.merge(
                    requests, {k: v * count for k, v in g.requests.items()}
                )
            nc = SchedNodeClaim.from_precomputed(
                nct,
                s.topology,
                s.daemon_overhead[nct],
                tracked_hp
                if tracked_hp is not None
                else HostPortUsage()
                if empty_hostports[nct]
                else _copy.deepcopy(s.daemon_hostports[nct]),
                options,
                s.reservation_manager,
                s.reserved_offering_mode,
                s.reserved_capacity_enabled,
                s.engine,
                c.hostname,
                reqs,
                list(c.members),
                requests,
            )
            nc.annotations[wk.NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY] = (
                "true" if c.min_relaxed else "false"
            )
            if self.res_active and c.reserved:
                # reservations were already applied to the shared manager at
                # join time; finalize_scheduling pins capacity-type +
                # reservation ids from this list (nodeclaim.go:207-220)
                nc.reserved_offerings = list(c.reserved)
            s.new_node_claims.append(nc)


def solve_device(scheduler, pods: Sequence[Pod], timeout: Optional[float] = 60.0):
    """Run the device-accelerated exact FFD; returns Results, or None → the
    caller uses the host loop (ineligible shape/solve)."""
    global DEVICE_SOLVES, DEVICE_FALLBACKS
    from karpenter_tpu_torch.scheduler.scheduler import Results

    if not eligible(scheduler, pods):
        DEVICE_FALLBACKS += 1
        _FALLBACKS_CTR.inc()
        return None
    from karpenter_tpu_torch.ops import ffd_topo

    if not ffd_topo.supported(scheduler):
        DEVICE_FALLBACKS += 1
        _FALLBACKS_CTR.inc()
        return None
    from karpenter_tpu_torch.ops import fused as fused_mod

    topo = scheduler.topology
    strict_reserved = _strict_reserved(scheduler)
    if (
        getattr(topo, "topology_groups", None)
        or getattr(topo, "inverse_topology_groups", None)
        # PreferNoSchedule pools: every pod may relax via the wildcard
        # toleration rung — only the topo driver drives the relax ladder
        or scheduler.preferences.tolerate_prefer_no_schedule
        # strict reserved mode: reservation exhaustion rejects candidates
        # non-monotonically and aborts pod scans — volatile paths only
        or strict_reserved
    ):
        attempts = [ffd_topo._TopoSolve]
        if fused_mod.fused_enabled(scheduler.engine):
            # the fused scan never drives the relax ladder / volatile paths
            fused_mod.note_decline("topo")
    else:
        # fused one-dispatch scan first (when enabled: on a CUDA engine by
        # default), then the plain driver (native kernel); shapes it
        # declines that only need the relax ladder (preferred/multi-term
        # node affinity) retry on the topo driver, which relaxes exactly
        # like the host
        attempts = list(fused_mod.maybe_attempts(scheduler)) + [
            _DeviceSolve,
            ffd_topo._TopoSolve,
        ]
    # A scan decline or an ineligible shape moves on to the next attempt,
    # and on the last one to the host loop, the semantics oracle; so does a
    # relaxed shape the topo driver declines (_Fallback). Any other error, a
    # kernel or device fault included, aborts the attempt (topology counts
    # and relaxed pods restored) and fails the solve: nothing covers a
    # device fault with the host loop.
    done = False
    for idx, cls in enumerate(attempts):
        last = idx == len(attempts) - 1
        solve = None
        try:
            solve = cls(scheduler, pods)
            solve.run(timeout)
            solve.emit()
            done = True
            break
        except (fused_mod._FusedDecline, _IneligibleShape):
            # not scan-shaped — the host-walk drivers are the designed slow
            # path (a decline is already metered by taxonomy reason)
            solve.abort()
            if not last:
                continue
            break
        except _Fallback:
            solve.abort()
            break
        except Exception:
            if solve is not None:
                solve.abort()
            raise
    if not done:
        DEVICE_FALLBACKS += 1
        _FALLBACKS_CTR.inc()
        return None
    DEVICE_SOLVES += 1
    _SOLVES_CTR.inc()
    for nc in scheduler.new_node_claims:
        nc.finalize_scheduling()
    return Results(
        new_node_claims=scheduler.new_node_claims,
        existing_nodes=scheduler.existing_nodes,
        pod_errors=solve.pod_errors,
        timed_out=solve.timed_out,
    )


# -- solverd coalescing hooks -------------------------------------------------


def collect_joint_rowsets(scheduler, pods: Sequence[Pod]) -> list[tuple]:
    """Enumerate the joint (template x group) requirement row-sets a device
    solve of `pods` would sweep, WITHOUT dispatching the sweep. Pure host
    work: grouping plus requirement algebra, all of it shared with the
    subsequent real solve through the scheduler/engine caches.

    Returns [(rows_frozenset, joint Requirements)] for pairs not yet in the
    engine's joint cache, or [] when the solve wouldn't take the device path
    (ineligible shape, tiny batch, degenerate shape count). solverd's
    coalescer unions these across concurrent requests so several solves
    share ONE batched device sweep (prime_joint_masks)."""
    if scheduler.engine is None or not eligible(scheduler, pods):
        return []
    try:
        solve = _DeviceSolve(scheduler, pods)
        if solve._group_pods() is None:
            return []
        pairs = solve._joint_pairs()
        if pairs is None:
            # degenerate shape counts evaluate joints lazily per pair
            # (_prepare_templates): there is no sweep to coalesce
            return []
        return [
            (rows, joint)
            for rows, joint in pairs
            if rows not in solve.joint_cache
        ]
    except Exception:  # noqa: BLE001 — priming is best-effort, never fatal
        return []


def collect_prefix_rowsets(schedulers_pods: Sequence[tuple]) -> list[tuple]:
    """Prefix-mask variant of collect_joint_rowsets for frontier groups:
    the k solves of a consolidation frontier round simulate nested prefixes
    of one candidate order, so their pod sets nest — every shape group (and
    therefore every joint (template x group) row-set) of a smaller prefix
    appears in the largest one. Collecting from the largest member alone
    yields the union the per-member loop would, for one prefix's worth of
    grouping work, and the single prime_joint_masks sweep that follows is
    the one feasibility pass all k prefixes share. Under-collection is
    impossible for nested inputs and harmless otherwise: priming only warms
    the joint cache — a solve whose pair wasn't primed computes it exactly,
    host-side, on demand."""
    if not schedulers_pods:
        return []
    scheduler, pods = max(schedulers_pods, key=lambda sp: len(sp[1]))
    return collect_joint_rowsets(scheduler, pods)


def prime_joint_masks(engine: "CatalogEngine", pairs: Sequence[tuple]) -> int:
    """Fill `engine.solver_joint_cache` for the given (rows, joint
    Requirements) pairs in ONE batched device sweep; solves that follow find
    their masks warm and dispatch nothing. Returns the number of fresh
    entries primed (0 → no device call was made).

    On sweep failure the reserved None placeholders stay behind — exact but
    slower: _joint_masks computes those entries host-side on demand."""
    global JOINT_SWEEPS
    fresh_rows: list[frozenset] = []
    fresh_reqs: list[Requirements] = []
    for rows, reqs in pairs:
        if rows in engine.solver_joint_cache:
            continue
        engine.solver_joint_cache[rows] = None  # reserve
        fresh_rows.append(rows)
        fresh_reqs.append(reqs)
    if not fresh_rows:
        return 0
    requests = np.zeros(
        (len(fresh_rows), len(engine.resource_dims)), dtype=np.float32
    )
    fz = engine.feasibility(
        [list(rows) for rows in fresh_rows],
        requests,
        engine.key_presence(fresh_reqs),
    )
    JOINT_SWEEPS += 1
    _JOINT_SWEEPS_CTR.inc()
    for i, rows in enumerate(fresh_rows):
        # copy: these persist on the engine; a row VIEW would pin the whole
        # padded sweep matrix alive (same rationale as _prepare_templates)
        engine.solver_joint_cache[rows] = (
            fz.compat[i].copy(),
            fz.has_offering[i].copy(),
        )
    return len(fresh_rows)
