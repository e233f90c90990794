"""Topology-aware device fast path: grouped FFD for solves with topology
machinery engaged.

The plain device path (ops/ffd.py) declines any solve with topology groups
because topology breaks the monotonicity its caches rely on: a claim that
rejects a pod for skew today may accept it after counts change. This module
extends the grouped simulation to topology-engaged solves — spread, pod
affinity/anti-affinity, and inverse anti-affinity from existing cluster
pods (reference scheduling/topology.go + topologygroup.go:205-408) — while
preserving EXACT host-decision parity:

- Pods collapse into shape groups keyed by the topo-aware signature (spec
  shape + namespace + labels + full constraint content — selectors match on
  labels, so labels are part of identity here, unlike the plain path).
- Groups that own topology groups are VOLATILE: their placements run the
  full host gate sequence per candidate (taints → compat → topology
  next-domain via the real `Topology.add_requirements` → instance-type
  narrowing through the engine's cached row masks). No monotone caching —
  skew rejections are not permanent.
- Plain groups keep the fast monotone path (heaps, family transitions), plus
  a record hook: the host records EVERY placement into any topology group
  whose selector matches the pod (topology.go:252-276), so counts stay
  exact even when only a minority of pods carry constraints.
- Decision-parity traps handled explicitly:
  * hostname placeholders: sorted-domain iteration makes placeholder STRINGS
    decision-relevant (topologygroup.go:269-276 hostname min-count, sorted
    scans), so topo solves draw hostnames from the host scheduler's counter
    (scheduler.nodeclaim._hostname_counter) at the host's exact consumption
    points — one per template attempt that passes the limits gate, matching
    NodeClaim construction in _add_to_new_node_claim (scheduler.go:478-556).
  * relaxation: the ladder (preferences.go) is driven exactly like the host
    — deepcopy, relax one step, topology.update + pod-data refresh, retry —
    with the relaxed copy migrating to its new shape group.
  * rollback: topology counts are snapshotted at solve start and restored if
    the solve aborts (fallback/strict), and relax-touched ownership is reset
    via topology.update(original), so a host fallback never sees device-
    mutated topology state.
"""

from __future__ import annotations

import copy
import heapq
import time
from bisect import bisect_left
from typing import Optional, Sequence

import numpy as np

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.ops.ffd import (
    _EPS,
    _DeviceSolve,
    _Fallback,
    _Group,
    _IneligibleShape,
    _raw_sig,
)
from karpenter_tpu_torch.ops import topo_counts
from karpenter_tpu_torch.ops.topo_counts import GroupCounts, build_gate
from karpenter_tpu_torch.scheduler import nodeclaim as ncmod
from karpenter_tpu_torch.scheduler.topology import (
    TYPE_AFFINITY,
    TYPE_ANTI_AFFINITY,
    TYPE_SPREAD,
)
from karpenter_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Operator,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.utils import resources as res

_TOPO_SOLVES_CTR = global_registry.counter(
    "karpenter_scheduler_device_topo_solves_total",
    "topology-engaged scheduling solves served by the device fast path",
)

# process-global interning for topo-aware signatures, parallel to
# ffd._SIG_IDS (separate space: the same spec shape means different things
# once labels/constraints matter)
_TSIG_IDS: dict[tuple, int] = {}
_TSIG_CAP = 200_000
_tsig_next = 0


def _intern_tsig(pod: Pod) -> int:
    """Interned topo-signature id for a pod, cached on the object."""
    global _tsig_next
    sig = getattr(pod, "_kt_tsig", None)
    if sig is None:
        raw = _topo_sig(pod)
        sig = _TSIG_IDS.get(raw)
        if sig is None:
            if len(_TSIG_IDS) >= _TSIG_CAP:
                _TSIG_IDS.clear()
            sig = _tsig_next
            _tsig_next += 1
            _TSIG_IDS[raw] = sig
        try:
            pod._kt_tsig = sig
        except Exception:  # noqa: BLE001 — slotted/frozen pod
            pass
    return sig


def supported(scheduler) -> bool:
    """Can this topology-engaged solve run on the device path?

    All group types are handled: spread, pod (anti-)affinity, and inverse
    anti-affinity from existing cluster pods (topology.go:55-58) — groups
    touching a shape make it volatile (full host gate sequence per
    candidate); everything else keeps the fast monotone path. The hook
    remains as the gate point for future unsupported constructs."""
    return True


def _sel_sig(sel) -> Optional[tuple]:
    if sel is None:
        return None
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            (e["key"], e["operator"], tuple(e.get("values", ())))
            for e in sel.match_expressions
        ),
    )


def _aff_term_sig(term) -> tuple:
    return (
        term.topology_key,
        _sel_sig(term.label_selector),
        tuple(term.namespaces),
        _sel_sig(term.namespace_selector),
    )


def _topo_sig(pod: Pod) -> tuple:
    """Shape signature for topology-engaged solves: the plain spec signature
    plus namespace, labels (selector targets), and full constraint content
    (spread, pod (anti-)affinity incl. preferred terms, preferred node
    affinity — all decision-relevant once topology groups exist)."""
    spec = pod.spec
    md = pod.metadata
    tsc = tuple(
        (
            t.topology_key,
            t.max_skew,
            t.when_unsatisfiable,
            _sel_sig(t.label_selector),
            t.min_domains,
            t.node_affinity_policy,
            t.node_taints_policy,
            tuple(t.match_label_keys),
        )
        for t in spec.topology_spread_constraints
    )
    pa_sig: tuple = ()
    panti_sig: tuple = ()
    pref_na_sig: tuple = ()
    aff = spec.affinity
    if aff is not None:
        if aff.pod_affinity is not None:
            pa_sig = (
                tuple(_aff_term_sig(t) for t in aff.pod_affinity.required),
                tuple(
                    (w.weight, _aff_term_sig(w.pod_affinity_term))
                    for w in aff.pod_affinity.preferred
                ),
            )
        if aff.pod_anti_affinity is not None:
            panti_sig = (
                tuple(_aff_term_sig(t) for t in aff.pod_anti_affinity.required),
                tuple(
                    (w.weight, _aff_term_sig(w.pod_affinity_term))
                    for w in aff.pod_anti_affinity.preferred
                ),
            )
        na = aff.node_affinity
        if na is not None and na.preferred:
            pref_na_sig = tuple(
                (
                    w.weight,
                    tuple(
                        (e["key"], e["operator"], tuple(e.get("values", ())))
                        for e in w.preference.match_expressions
                    ),
                )
                for w in na.preferred
            )
    ports_sig = tuple(
        (p.host_port, p.host_ip, p.protocol)
        for c in list(spec.containers) + list(spec.init_containers)
        for p in c.ports
        if p.host_port != 0
    )
    return (
        _raw_sig(pod),
        md.namespace,
        tuple(sorted(md.labels.items())) if md.labels else (),
        tsc,
        pa_sig,
        panti_sig,
        pref_na_sig,
        ports_sig,
    )


def _group_eligible_topo(pod: Pod) -> bool:
    """Per-shape gates for topo mode: every remaining shape feature is
    handled — topology constraints (relax ladder + volatile paths), host
    ports (conflict-tracked), and volumes (per-pod CSI attach-limit checks
    against existing nodes; volume-derived zone requirements were already
    injected by VolumeTopology before the solve)."""
    return True


class _ScanOrder:
    """The host's in-flight claim scan order, maintained incrementally.

    The host stable-sorts claims by pod count before every scan
    (scheduler.go:457-459); (count, rank, ci) reproduces that order exactly
    (see _host_claim_order). Keys are unique (ci tiebreak), so each join is
    one bisect-delete + bisect-insert instead of a full re-sort per attempt."""

    __slots__ = ("keys", "cis")

    def __init__(self):
        self.keys: list[tuple] = []
        self.cis: list[int] = []

    def add(self, ci: int, key: tuple) -> None:
        i = bisect_left(self.keys, key)
        self.keys.insert(i, key)
        self.cis.insert(i, ci)

    def move(self, ci: int, old_key: tuple, new_key: tuple) -> None:
        i = bisect_left(self.keys, old_key)
        del self.keys[i]
        del self.cis[i]
        self.add(ci, new_key)


# sentinel domain in record plans: resolve to the claim's hostname
_HOSTNAME_DOMAIN = object()

# claim-entry kinds in compiled join plans (hostname-keyed groups: the
# domain is the claim's own hostname, so admission is per claim, not per
# family — each collapses to a count lookup against the host dict)
_CE_ANTI = 0  # reject unless domains[hostname] == 0 (topologygroup.go:380-387)
_CE_SPREAD = 1  # admit iff count(+self) <= maxSkew (topologygroup.go:215-227)
_CE_AFFINITY = 2  # HostAffinityGate (count > 0, or gen-cached self-seed)


class _TopoSolve(_DeviceSolve):
    """Grouped FFD with exact topology semantics (Python driver only — the
    native kernel's steady-state caches assume monotone rejections, which
    topology breaks, so topo solves run the instrumented Python loop)."""

    def __init__(self, scheduler, pods: Sequence[Pod]):
        super().__init__(scheduler, pods)
        self.topology = scheduler.topology
        self._sig_to_gi: dict[int, int] = {}
        self.g_volatile: list[bool] = []
        self.g_rec: list[list] = []  # groups whose selector matches the shape
        self.g_matched: list[list] = []  # owned + inverse-selected, host order
        self.g_inv_owned: list[list] = []  # inverse groups the shape owns
        self.g_relaxable: list[bool] = []
        self.g_rep: list[Pod] = []  # shape representative (for meta refresh)
        self.g_ports: list[list] = []  # host ports per shape (usually empty)
        self._any_ports = False  # _claim_hp (base class) tracked when True
        self.g_volumes: list[bool] = []  # shape has PVC-backed volumes
        self._any_volumes = False
        self._known_tg_count = len(self.topology.topology_groups) + len(
            self.topology.inverse_topology_groups
        )
        self._hn_tgs = [
            tg
            for tg in (
                list(self.topology.topology_groups.values())
                + list(self.topology.inverse_topology_groups.values())
            )
            if tg.key == wk.LABEL_HOSTNAME
        ]
        self._hostname_tgs = bool(self._hn_tgs)
        self._saved_topology: Optional[tuple] = None
        self._saved_node_usage: list[tuple] = []
        self._relax_restore: dict[str, Pod] = {}
        self._aborted = False
        self._scan = _ScanOrder()
        # steady-state fast-join plans per (fam, gi): None = slow path
        self._join_plans: dict[tuple[int, int], Optional[list]] = {}
        # record plans per (gi, ti, fam)
        self._rec_plans: dict[tuple[int, int, int], tuple] = {}
        # -- device count-tensor state (ops/topo_counts.py) -----------------
        # count tensors per live TopologyGroup (keyed by object identity;
        # groups outlive the solve via the topology dicts / snapshot)
        self._tg_counts: dict[int, GroupCounts] = {}
        # compiled admission gates per (gi, topology group): the pod-domain
        # row and self-selection are shape-static, so one gate serves every
        # family/claim probe of the pair
        self._gates: dict[tuple[int, int], object] = {}
        # fam-level admission verdicts per (gi, fam), validated against the
        # matched groups' count generations: (ok, gen0, gen1, ...) — a probe
        # between placements is a dict hit plus integer compares
        self._fam_adm: dict[tuple[int, int], tuple] = {}
        # claim-opening memo per shape group: (tokens, gens, outcomes) —
        # the host template loop replayed as placeholder draws + a cached
        # opening while the matched groups' count generations stand still
        # (see _new_claim_topo)
        self._open_memo: dict[int, tuple] = {}
        self._fresh_hostnames_safe = False
        # monotone-scan classification per shape group (None = undecided):
        # True when every matched topology group is hostname anti-affinity
        # and no per-candidate state accumulates (ports/volumes/hostname/
        # strict-reserved) — then ALL rejection reasons are permanent and
        # the claim scan runs over a lazily-synced heap with pop-on-reject,
        # killing the O(pods x claims) probe on anti-affinity-heavy solves
        self.g_mono: list[Optional[bool]] = []
        # hostname-group-set epoch for once-per-claim hostname registration
        self._hn_epoch = 0

    # -- incremental host scan order ----------------------------------------

    def _order_hook_add(self, ci: int) -> None:
        c = self.claims[ci]
        self._scan.add(ci, (c.count, c.rank, ci))

    def _order_hook_move(self, ci: int, old_key: tuple, new_key: tuple) -> None:
        self._scan.move(ci, old_key, new_key)

    # -- grouping -----------------------------------------------------------

    def _group_pods(self) -> Optional[np.ndarray]:
        pods = self.pods
        # warm fast path: pods persist across provisioner passes and carry
        # their interned topo-signature (mirrors ffd._group_pods)
        try:
            sigs = np.asarray([p._kt_tsig for p in pods], dtype=np.int64)
        except AttributeError:
            sigs = np.empty(len(pods), dtype=np.int64)
            for i, pod in enumerate(pods):
                sigs[i] = _intern_tsig(pod)
        _, first_idx, inverse, counts = np.unique(
            sigs, return_index=True, return_inverse=True, return_counts=True
        )
        for k, fi in enumerate(first_idx):
            pod = pods[int(fi)]
            gi = self._build_group(pod)
            if gi is None:
                return None
            self.groups[gi].n_pods = int(counts[k])
            self._sig_to_gi[int(sigs[int(fi)])] = gi
        return inverse.astype(np.int32)

    def _build_group(self, pod: Pod) -> Optional[int]:
        """Create the shape group for `pod` (its signature's representative);
        returns the group index, or None when the shape is ineligible."""
        s, dims = self.s, self.dims
        if not _group_eligible_topo(pod):
            return None
        s.update_cached_pod_data(pod)
        data = s.cached_pod_data[pod.metadata.uid]
        if any(name not in dims for name in data.requests):
            return None
        group = _Group(data, dims)
        # hostname-constrained shapes are handled VOLATILE: the claim scan
        # gates on the pod's hostname row against each claim's placeholder
        # (can_add's compat rejection, nodeclaim.go:285-291), and new-claim
        # attempts reproduce the host's compat error with the exact consumed
        # placeholder string — this driver draws from the host's counter, so
        # even pathological selectors naming placeholder strings behave
        # identically to a pure host run
        group.rowset = self._rows_sans_hostname(group.reqs)
        gi = len(self.groups)
        self.groups.append(group)
        self.gheaps.append([])
        self.gsynced.append(0)
        self.nptr.append(0)
        # SNAPSHOT the representative: a mid-relax pod keeps mutating in
        # place on later rungs, and _maybe_refresh_groups recomputes this
        # group's topology metadata from its rep — a live reference would
        # silently shift the group onto the FUTURE shape's topology groups
        # (soak seed 101: a wildcard-toleration rung re-pointed a pre-relax
        # group at a fresh-count spread group, admitting an over-skew join)
        self.g_rep.append(copy.deepcopy(pod))
        self.g_relaxable.append(self._shape_relaxable(pod))
        from karpenter_tpu_torch.scheduling.hostportusage import get_host_ports

        ports = get_host_ports(pod)
        self.g_ports.append(ports)
        if ports:
            self._any_ports = True
        has_volumes = bool(getattr(pod.spec, "volumes", None))
        self.g_volumes.append(has_volumes)
        if has_volumes:
            self._any_volumes = True
        self._append_group_meta(pod, ports, has_volumes, group.has_hostname)
        return gi

    def _append_group_meta(
        self, pod: Pod, ports: list, has_volumes: bool, has_hostname: bool
    ) -> None:
        """Per-shape topology metadata (also recomputed by
        _maybe_refresh_groups when relaxation creates new groups mid-solve)."""
        topo = self.topology
        owned = self._shape_owned(pod)
        # inverse groups match via counts() = selects() (their node filter is
        # the permissive zero value, topologynodefilter.go:27-40) — a shape
        # an existing pod's anti-affinity selector matches is volatile too;
        # host-port, volume, and hostname-constrained shapes are volatile
        # too (their admission state accumulates per candidate / is per-pod)
        inv_matched = [
            tg for tg in topo.inverse_topology_groups.values() if tg.selects(pod)
        ]
        self.g_volatile.append(
            bool(
                owned
                or inv_matched
                or ports
                or has_volumes
                or has_hostname
                # strict reserved: every join runs the reservation gate at
                # the host's can_add position, and its rejections are not
                # monotone (capacity frees on release)
                or self.strict_res
            )
        )
        # host matching order: owned groups in dict order, then matching
        # inverse groups (topology.py _matching_topologies)
        matched = owned + inv_matched
        self.g_matched.append(matched)
        self.g_rec.append(
            [tg for tg in topo.topology_groups.values() if tg.selects(pod)]
        )
        self.g_inv_owned.append(
            [
                tg
                for tg in topo.inverse_topology_groups.values()
                if tg.is_owned_by(pod.metadata.uid)
            ]
        )
        # monotone classification: hostname anti-affinity counts only grow
        # during a solve, so every rejection reason on the claim scan is
        # permanent and the scan can pop claims from a per-group heap
        self.g_mono.append(
            bool(matched)
            and not ports
            and not has_volumes
            and not has_hostname
            and not self.strict_res
            and all(
                tg.type == TYPE_ANTI_AFFINITY and tg.key == wk.LABEL_HOSTNAME
                for tg in matched
            )
        )

    def _shape_owned(self, pod: Pod) -> list:
        """Groups a pod of this shape owns, derived from the topology
        engine's shape memo (value identity) rather than per-uid ownership —
        per-uid state is transiently wrong for the pod currently mid-relax.
        Returned in topology_groups dict order (the host's matching order)."""
        from karpenter_tpu_torch.scheduler.topology import _pod_shape_key

        topo = self.topology
        memo = topo._shape_groups.get(_pod_shape_key(pod))
        if memo is None:
            # shape never passed through update() — pods without topology
            # constraints own nothing
            if pod.spec.topology_spread_constraints or pod.spec.affinity is not None:
                uid = pod.metadata.uid
                return [
                    tg for tg in topo.topology_groups.values() if tg.is_owned_by(uid)
                ]
            return []
        owned_ids = set(map(id, memo))
        return [tg for tg in topo.topology_groups.values() if id(tg) in owned_ids]

    def _maybe_refresh_groups(self) -> None:
        """Relaxation's topology.update can CREATE topology groups mid-solve
        (a relaxed shape's node-filter hash differs): the host records
        subsequent placements into them, so every per-shape list and compiled
        plan must be rebuilt to include them."""
        topo = self.topology
        n = len(topo.topology_groups) + len(topo.inverse_topology_groups)
        if n == self._known_tg_count:
            return
        self._known_tg_count = n
        self._hn_tgs = [
            tg
            for tg in (
                list(topo.topology_groups.values())
                + list(topo.inverse_topology_groups.values())
            )
            if tg.key == wk.LABEL_HOSTNAME
        ]
        self._hostname_tgs = bool(self._hn_tgs)
        # claims lazily re-register their hostnames into the grown group set
        # on their next join (the host registers on every NodeClaim.add, so a
        # claim that never joins again never registers — epoch-lazy matches)
        self._hn_epoch += 1
        self.g_volatile.clear()
        self.g_matched.clear()
        self.g_rec.clear()
        self.g_inv_owned.clear()
        self.g_mono.clear()
        for rep, ports, has_vols, group in zip(
            self.g_rep, self.g_ports, self.g_volumes, self.groups
        ):
            self._append_group_meta(rep, ports, has_vols, group.has_hostname)
        self._rec_plans.clear()
        self._join_plans.clear()
        self._fam_adm.clear()
        self._open_memo.clear()
        # matched sets (and volatility itself) may have changed: rebuild
        # every group's claim heap from scratch so claims popped under the
        # OLD gates are re-probed under the new ones (plain-path drops are
        # re-derived from the per-claim gdrop sets on the first rescan)
        for gi in range(len(self.gheaps)):
            self.gheaps[gi] = []
            self.gsynced[gi] = 0
        # (no snapshot extension needed: abort() restores the pre-solve group
        # DICTS, discarding mid-solve-created groups entirely)

    def _shape_relaxable(self, pod: Pod) -> bool:
        """Does the relaxation ladder (preferences.go:33-145) have anything
        to remove for this shape? Mirrors Preferences.relax applicability."""
        spec = pod.spec
        aff = spec.affinity
        if aff is not None:
            na = aff.node_affinity
            if na is not None and (na.preferred or len(na.required) > 1):
                return True
            if aff.pod_affinity is not None and aff.pod_affinity.preferred:
                return True
            if aff.pod_anti_affinity is not None and aff.pod_anti_affinity.preferred:
                return True
        if any(
            t.when_unsatisfiable == "ScheduleAnyway"
            for t in spec.topology_spread_constraints
        ):
            return True
        if self.s.preferences.tolerate_prefer_no_schedule:
            # the ladder's final rung adds a wildcard PreferNoSchedule
            # toleration (preferences.go:133-145) unless already present
            for t in spec.tolerations:
                if (
                    t.operator == "Exists"
                    and t.effect == "PreferNoSchedule"
                    and t.key == ""
                    and t.value == ""
                ):
                    return False
            return True
        return False

    def _ensure_group(self, pod: Pod) -> Optional[int]:
        """Group index for a relaxed copy, creating its shape group lazily.
        cached_pod_data[uid] was already refreshed by the caller (mirroring
        the host's update_cached_pod_data after relax)."""
        sig = _intern_tsig(pod)
        gi = self._sig_to_gi.get(sig)
        if gi is None:
            gi = self._build_group(pod)
            if gi is None:
                return None
            self._sig_to_gi[sig] = gi
        return gi

    # -- topology state management ------------------------------------------

    def _snapshot_topology(self) -> None:
        # counts + group dicts via the engine's snapshot/rollback contract
        # (scheduler/topology.py): a restore also stamps fresh count
        # generations, so device count tensors can never alias rolled-back
        # state
        self._saved_topology = self.topology.snapshot_counts()
        # Freshly drawn hostname placeholders have occupancy 0 in every
        # hostname group UNLESS the cluster pathologically contains
        # placeholder-shaped domains already (store pods / node names):
        # every placeholder recorded mid-solve comes from the monotonic
        # counter and is strictly older than any future draw. The flag
        # gates the claim-opening memo's hostname-freshness assumption.
        self._fresh_hostnames_safe = not any(
            d.startswith("hostname-placeholder-")
            for tg in self._hn_tgs
            for d in tg.domains
        )
        # port/volume joins fork usage onto the ExistingNode (copy-on-write
        # — the StateNode itself is never written); a fallback must still
        # not leave phantom fork entries behind for the host loop to read
        if self._any_ports or self._any_volumes:
            self._saved_node_usage = [
                (nd.en, nd.en.usage_snapshot()) for nd in self.nodes
            ]

    def abort(self) -> None:
        """Restore topology to its pre-solve state so the host fallback runs
        against uncorrupted counts, ownership, and group sets."""
        if self._aborted:
            return
        self._aborted = True
        self._restore_rm()
        topo = self.topology
        if self._saved_topology is not None:
            topo.restore_counts(self._saved_topology)
        for en, usage in self._saved_node_usage:
            en.restore_usage(usage)
        for orig in self._relax_restore.values():
            topo.update(orig)
            self.s.update_cached_pod_data(orig)
        self._relax_restore.clear()

    # -- record hooks (NodeClaim.add / ExistingNode.add tails) ---------------

    def _needs_record(self, gi: int) -> bool:
        # only reached on non-volatile branches; inverse-group OWNERS have
        # required anti-affinity and thus own a regular group too → volatile,
        # so inverse record bookkeeping never needs gating here
        return bool(self.g_rec[gi]) or self._hostname_tgs

    # -- record plans (NodeClaim.add tail, nodeclaim.go:324-346) -------------
    #
    # The host registers the claim hostname and records into every group
    # whose selector matches the pod and whose node filter admits the claim.
    # For claims all inputs are (shape, template, family)-determined: selects
    # is per shape (g_rec), the node filter per (group, taints, family), and
    # the recorded domain per family row (or the claim's hostname). The plan
    # compiles that once; applying it is a handful of dict increments.

    def _build_rec_plan(self, gi: int, ti: int, fam: int) -> tuple:
        """Entries carry the group's count tensor directly (created on
        first record if the group has none yet) so applying a plan is a
        straight-line scatter into tensor + host dict per entry."""
        reqs = self.fam_reqs[fam]
        taints = self.s.nodeclaim_templates[ti].spec.taints
        entries: list[tuple] = []
        for tg in self.g_rec[gi]:
            if not tg.node_filter.matches(
                taints, reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
            ):
                continue
            if tg.key == wk.LABEL_HOSTNAME:
                # the claim's hostname row is always single-valued. Hostname
                # groups stay dict-backed (their gates are single lookups and
                # per-claim registrations would churn a tensor), so the entry
                # carries the group itself — record() has the same shape.
                entries.append((tg, _HOSTNAME_DOMAIN))
                continue
            row = reqs.get(tg.key) if reqs.has(tg.key) else None
            if tg.type == TYPE_ANTI_AFFINITY:
                vals = tuple(row.values_list()) if row is not None else ()
                if vals:
                    entries.append((self._group_counts(tg), vals))
            elif row is not None and not row.complement and len(row.values) == 1:
                entries.append((self._group_counts(tg), next(iter(row.values))))
        inv: list[tuple] = []
        for tg in self.g_inv_owned[gi]:
            if tg.key == wk.LABEL_HOSTNAME:
                inv.append((tg, _HOSTNAME_DOMAIN))
                continue
            row = reqs.get(tg.key) if reqs.has(tg.key) else None
            vals = tuple(row.values_list()) if row is not None else ()
            if vals:
                inv.append((self._group_counts(tg), vals))
        plan = (entries, inv)
        self._rec_plans[(gi, ti, fam)] = plan
        return plan

    def _apply_record_plan(self, gi: int, c) -> None:
        if self._hostname_tgs and c.hn_epoch != self._hn_epoch:
            # register once per (claim, hostname-group-set epoch): the host
            # registers on every NodeClaim.add, but registration of a known
            # domain is a no-op, and hostnames are never unregistered
            # mid-solve — so the first registration per epoch is exact
            for tg in self._hn_tgs:
                tg.register(c.hostname)
            c.hn_epoch = self._hn_epoch
        plan = self._rec_plans.get((gi, c.ti, c.fam))
        if plan is None:
            plan = self._build_rec_plan(gi, c.ti, c.fam)
        entries, inv = plan
        for gc, dom in entries:
            if dom is _HOSTNAME_DOMAIN:
                gc.record(c.hostname)
            elif type(dom) is tuple:
                gc.record(*dom)
            else:
                gc.record(dom)
        for gc, vals in inv:
            if vals is _HOSTNAME_DOMAIN:
                gc.record(c.hostname)
            else:
                gc.record(*vals)

    # -- volatile paths ------------------------------------------------------

    def _try_nodes_topo(self, pod: Pod, g: _Group, gi: int) -> bool:
        """Existing-node scan for topology-owning shapes: full rescan in host
        order every attempt (skew admission is not monotone), the real
        Topology.add_requirements in the gate sequence
        (existingnode.go:63-101)."""
        topo = self.topology
        gp = self.g_ports[gi]
        vols = None
        if self.g_volumes[gi]:
            from karpenter_tpu_torch.scheduling.volumeusage import get_volumes

            vols = get_volumes(self.s.store, pod)
        for nd in self.nodes:
            tol = nd.gtol.get(gi)
            if tol is None:
                tol = Taints(nd.en.cached_taints).tolerates_pod(pod) is None
                nd.gtol[gi] = tol
            if not tol:
                continue
            if (
                vols is not None
                and nd.en.volume_usage.exceeds_limits(vols) is not None
            ):
                continue
            if gp and nd.en.hostport_usage.conflicts(pod, gp) is not None:
                continue
            kc = nd.gcap.get(gi)
            if kc is None or kc[0] != nd.usage_ver:
                k = self._node_capacity(nd, g)
                nd.gcap[gi] = (nd.usage_ver, k)
            else:
                k = kc[1]
            if k <= 0:
                continue
            cc = nd.gcompat.get(gi)
            if cc is None or cc[0] != nd.version:
                ok = nd.reqs.compatible(g.reqs) is None
                nd.gcompat[gi] = (nd.version, ok)
            else:
                ok = cc[1]
            if not ok:
                continue
            joint = Requirements(*nd.reqs.values())
            joint.add(*g.reqs.values())
            try:
                topo_reqs = topo.add_requirements(
                    pod, nd.en.cached_taints, g.strict_reqs, joint
                )
            except ValueError:
                continue
            if joint.compatible(topo_reqs) is not None:
                continue
            joint.add(*topo_reqs.values())
            nd.joined.append(pod)
            nd.remaining = res.subtract(nd.remaining, g.requests)
            nd.reqs = joint
            nd.version += 1
            nd.usage_ver += 1
            topo.record(pod, nd.en.cached_taints, joint)
            if gp:
                nd.en.fork_usage()
                nd.en.hostport_usage.add(pod, gp)
            if vols is not None:
                nd.en.fork_usage()
                nd.en.volume_usage.add(pod, vols)
            return True
        return False

    # -- steady-state fast joins --------------------------------------------
    #
    # When a group's rows are subsumed by the claim family (_SAME) and every
    # matched topology group's key has a single-valued family row (or is the
    # hostname), the full host evaluation collapses: admission is a read
    # against the group's device count tensor (ops/topo_counts.py) — the
    # same verdict tg.get() would compute, served from a masked reduction
    # cached per count generation — and admission implies the joint is
    # unchanged (chosen ∋ v ⇒ {v} ∩ chosen = {v}), so no Requirements are
    # built at all. Rejection is exact too: chosen missing v is precisely
    # the host's compatibility error (or the empty-domain raise). Anything
    # else takes the slow path below, which calls the real host oracle
    # (Topology.add_requirements) and mirrors nodeclaim.go:114-163 verbatim.

    def _group_counts(self, tg) -> GroupCounts:
        gc = self._tg_counts.get(id(tg))
        if gc is None:
            gc = self._tg_counts[id(tg)] = GroupCounts(tg)
        return gc

    def _gate(self, gi: int, tg, pod_dom):
        """Compiled count-tensor admission gate per (shape group, topology
        group) — the pod-domain row and self-selection are shape-static."""
        key = (gi, id(tg))
        gate = self._gates.get(key)
        if gate is None:
            rep = self.g_rep[gi]
            gate = build_gate(
                self._group_counts(tg), pod_dom, tg.selects(rep), rep
            )
            self._gates[key] = gate
        return gate

    def _host_aff_gate(self, gi: int, tg, pod_dom):
        key = ("hn", gi, id(tg))
        gate = self._gates.get(key)
        if gate is None:
            gate = topo_counts.HostAffinityGate(
                tg, pod_dom, tg.selects(self.g_rep[gi])
            )
            self._gates[key] = gate
        return gate

    def _build_join_plan(self, fam: int, gi: int):
        """Compiled plan split into FAM-LEVEL entries (single-valued family
        rows — the verdict is identical for every claim of the family, so
        one gen-cached gate read serves the whole scan) and PER-CLAIM
        entries (hostname ops, which read the claim's own hostname).
        Returns (fam_entries, claim_entries) or None."""
        reqs = self.fam_reqs[fam]
        g = self.groups[gi]
        fam_entries: list[tuple] = []
        claim_entries: list[tuple] = []
        plan = (fam_entries, claim_entries)
        for tg in self.g_matched[gi]:
            pod_dom = g.strict_reqs.get(tg.key)
            if tg.key == wk.LABEL_HOSTNAME:
                if tg.type == TYPE_ANTI_AFFINITY:
                    claim_entries.append((_CE_ANTI, tg, 0))
                elif tg.type == TYPE_SPREAD:
                    s = 1 if tg.selects(self.g_rep[gi]) else 0
                    claim_entries.append((_CE_SPREAD, tg, s))
                else:
                    claim_entries.append(
                        (_CE_AFFINITY, self._host_aff_gate(gi, tg, pod_dom), 0)
                    )
                continue
            row = reqs.get(tg.key) if reqs.has(tg.key) else None
            if row is None or row.complement or len(row.values) != 1:
                plan = None
                break
            z = next(iter(row.values))
            gate = self._gate(gi, tg, pod_dom)
            fam_entries.append((gate, gate.intern(z), z, row, tg))
        self._join_plans[(fam, gi)] = plan
        return plan

    def _fam_admission(self, gi: int, fam: int, fam_entries: list) -> bool:
        """Fam-level verdict over the compiled gates, cached per (gi, fam)
        and validated against the matched groups' count generations — the
        probe between two placements is a dict hit plus an integer compare.
        Single-gate fams (the dominant case) store a flat (ok, gen, tg)
        triple; multi-gate fams a (ok, None, entries, gens) record."""
        akey = (gi, fam)
        cached = self._fam_adm.get(akey)
        if cached is not None:
            tg0 = cached[1]
            if tg0 is not None:  # flat single-gate form
                if cached[2] == tg0._gen:
                    return cached[0]
            else:
                entries, gens = cached[3], cached[4]
                k = 0
                for entry in entries:
                    if gens[k] != entry[4]._gen:
                        break
                    k += 1
                else:
                    return cached[0]
        ok = True
        for gate, zid, z, row, _tg in fam_entries:
            if type(gate) is topo_counts.AffinityGate:
                good = gate.ok_with_row(zid, z, row)
            else:
                good = gate.ok(zid)
            if not good:
                ok = False
                break
        if len(fam_entries) == 1:
            tg0 = fam_entries[0][4]
            self._fam_adm[akey] = (ok, tg0, tg0._gen, fam_entries)
        else:
            self._fam_adm[akey] = (
                ok,
                None,
                None,
                fam_entries,
                tuple(e[4]._gen for e in fam_entries),
            )
        return ok

    def _commit_join(self, c, ci: int, pod: Pod, g: _Group, gi: int, fitrows) -> None:
        """Join tail shared by fast and slow paths: usage grows, rows that
        stop fitting die forever, scan order updated."""
        if fitrows.all():
            c.rem = c.rem - g.req_f
        else:
            c.rem = c.rem[fitrows] - g.req_f
            c.u_ids = c.u_ids[fitrows]
        old_key = (c.count, c.rank, ci)
        c.count += 1
        self.seq += 1
        c.rank = -self.seq
        c.members.append(pod)
        c.group_counts[gi] = c.group_counts.get(gi, 0) + 1
        self._scan.move(ci, old_key, (c.count, c.rank, ci))
        if self.res_active:
            self._apply_reserved(c, self._pending_reserved)
            self._pending_reserved = None

    def _probe_claim(self, pod: Pod, g: _Group, gi: int, c, ci: int) -> bool:
        """One host can_add evaluation of claim `ci` for `pod`
        (nodeclaim.go:114-163), committing the join on success. Under a
        monotone-classified group (g_mono) every False returned here is a
        PERMANENT rejection — the callers rely on that to pop claims."""
        templates = self.s.nodeclaim_templates
        tol = self.tg_tol.get((c.ti, gi))
        if tol is None:
            tol = Taints(templates[c.ti].spec.taints).tolerates_pod(pod) is None
            self.tg_tol[(c.ti, gi)] = tol
        if not tol:
            return False
        gp = self.g_ports[gi]
        # host ports (nodeclaim.go:280-283): conflicts against the claim's
        # accumulated usage reject this candidate
        if gp and self._claim_hp[ci].conflicts(pod, gp) is not None:
            return False
        # hostname-constrained shapes: the host's compat gate sees the
        # claim's placeholder hostname row vs the pod's hostname row
        # (nodeclaim.go:285-291) — reject unless the placeholder satisfies
        # the pod's requirement (NotIn rows usually pass, In[real] never do)
        if g.has_hostname and not g.reqs.get(wk.LABEL_HOSTNAME).has(c.hostname):
            return False
        ent = self.fam_join.get((c.fam, gi))
        if ent is None:
            ent = self._build_fam_join(c.fam, gi)
        if ent[0] == self._REJECT:
            return False
        if ent[0] == self._SAME:
            plan = self._join_plans.get((c.fam, gi), self._MISSING)
            if plan is self._MISSING:
                plan = self._build_join_plan(c.fam, gi)
            if plan is not None:
                fam_entries, claim_entries = plan
                # fam-level gates: one gen-validated tensor read serves
                # every claim of the family until a count changes
                if fam_entries and not self._fam_admission(gi, c.fam, fam_entries):
                    return False
                h = c.hostname
                for kind, obj, s in claim_entries:
                    if kind == _CE_ANTI:
                        # "no matching pod on this host yet"
                        # (topologygroup.go:380-387 fast path)
                        if obj.domains.get(h, 0) != 0:
                            return False
                    elif kind == _CE_SPREAD:
                        # hostname spread fast path: a fresh hostname is
                        # always a valid new domain (min count 0), so the
                        # bound is count(+self) <= maxSkew
                        # (topologygroup.go:215-227, 269-273)
                        if obj.domains.get(h, 0) + s > obj.max_skew:
                            return False
                    elif not obj.ok(h):  # _CE_AFFINITY
                        return False
                d = c.defer
                if d is not None:
                    # deferred fast commit: any-fit over the OPEN-time
                    # pareto rows against accumulated usage (row pruning
                    # telescopes — see _Claim.defer); no row arrays touched
                    pareto, extra = d
                    floor = g.floor_list
                    nd_ = len(floor)
                    for row in pareto:
                        k = 0
                        while k < nd_ and row[k] - extra[k] >= floor[k]:
                            k += 1
                        if k == nd_:
                            break
                    else:
                        return False
                    req = g.req_list
                    for k in range(nd_):
                        extra[k] += req[k]
                    old_key = (c.count, c.rank, ci)
                    c.count += 1
                    self.seq += 1
                    c.rank = -self.seq
                    c.members.append(pod)
                    c.group_counts[gi] = c.group_counts.get(gi, 0) + 1
                    self._scan.move(ci, old_key, (c.count, c.rank, ci))
                    self._apply_record_plan(gi, c)
                    if gp:
                        self._claim_hp[ci].add(pod, gp)
                    return True
                fitrows = (c.rem >= g.fit_floor).all(axis=1)
                if not fitrows.any():
                    return False
                if (
                    self.min_active
                    and not fitrows.all()
                    and not self._min_join_ok(c, c.u_ids[fitrows])
                ):
                    return False
                if self.strict_res:
                    # host can_add position: a ReservedOfferingError here
                    # rejects THIS candidate only — the inflight scan
                    # swallows per-candidate errors (scheduler.go:519-534)
                    try:
                        self._pending_reserved = self._reserved_eval(
                            c.hostname,
                            self.fam_reqs[c.fam],
                            self._final_types(c.type_mask, c.u_ids[fitrows]),
                            fam=c.fam,
                            current_reserved=c.reserved,
                        )
                    except ncmod.ReservedOfferingError:
                        return False
                self._commit_join(c, ci, pod, g, gi, fitrows)
                self._apply_record_plan(gi, c)
                if gp:
                    self._claim_hp[ci].add(pod, gp)
                return True
        # slow path: full host gate sequence with real Requirements.
        # joint BEFORE topology = claim reqs + pod reqs, hostname row
        # included (nodeclaim.go:285-291)
        if c.defer is not None:
            self._materialize(c)
        topo = self.topology
        base = self.fam_reqs[c.fam] if ent[0] == self._SAME else ent[3]
        joint = Requirements(*base.values())
        joint.add(Requirement(wk.LABEL_HOSTNAME, Operator.IN, [c.hostname]))
        try:
            topo_reqs = topo.add_requirements(
                pod,
                templates[c.ti].spec.taints,
                g.strict_reqs,
                joint,
                ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
            )
        except ValueError:
            return False
        if joint.compatible(topo_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS) is not None:
            return False
        joint.add(*topo_reqs.values())
        final_rows = self._rows_sans_hostname(joint)
        if final_rows == self.fam_rows[c.fam]:
            fitrows = (c.rem >= g.fit_floor).all(axis=1)
            if not fitrows.any():
                return False
            if (
                self.min_active
                and not fitrows.all()
                and not self._min_join_ok(c, c.u_ids[fitrows])
            ):
                return False
            if self.strict_res:
                try:
                    # rows unchanged ⟹ content equals the fam's — the
                    # (fam, offering) compat memo applies
                    self._pending_reserved = self._reserved_eval(
                        c.hostname,
                        joint,
                        self._final_types(c.type_mask, c.u_ids[fitrows]),
                        fam=c.fam,
                        current_reserved=c.reserved,
                    )
                except ncmod.ReservedOfferingError:
                    return False
        else:
            compat_v, offer_v = self._joint_masks(final_rows, joint)
            new_mask = c.type_mask & compat_v & offer_v
            surv_u = np.zeros(self.U, dtype=bool)
            surv_u[self.uid_of_type[new_mask]] = True
            keep = surv_u[c.u_ids]
            fitrows = keep & (c.rem >= g.fit_floor).all(axis=1)
            if not fitrows.any():
                return False
            if self.min_active and not self._min_join_ok(
                c, c.u_ids[fitrows], new_mask
            ):
                return False
            if self.strict_res:
                try:
                    self._pending_reserved = self._reserved_eval(
                        c.hostname,
                        joint,
                        self._final_types(new_mask, c.u_ids[fitrows]),
                        current_reserved=c.reserved,
                    )
                except ncmod.ReservedOfferingError:
                    return False
            c.type_mask = new_mask
            c.rem = c.rem[keep]
            c.u_ids = c.u_ids[keep]
            c.fam = self._intern_fam(final_rows, self._sans_hostname(joint))
            fitrows = fitrows[keep]
        self._commit_join(c, ci, pod, g, gi, fitrows)
        self._apply_record_plan(gi, c)
        if gp:
            self._claim_hp[ci].add(pod, gp)
        return True

    def _try_claims_topo(self, pod: Pod, g: _Group, gi: int) -> bool:
        if self.g_mono[gi]:
            return self._try_claims_mono(pod, g, gi)
        # general scan: skew/affinity admission is not monotone (counts
        # elsewhere can re-admit a claim), so every attempt rescans the
        # in-flight claims in host order. Claims whose family is CACHED
        # inadmissible (and whose gate generations haven't moved) are
        # skipped without paying the probe.
        claims = self.claims
        cis = self._scan.cis
        fam_adm = self._fam_adm
        i = 0
        n = len(cis)
        while i < n:
            ci = cis[i]
            i += 1
            c = claims[ci]
            cached = fam_adm.get((gi, c.fam))
            if cached is not None:
                # resolve the fam verdict HERE (re-evaluating stale entries
                # through the count gates) so inadmissible claims skip the
                # whole probe prefix; the probe's own check then hits warm.
                # Only the flat single-gate fresh path is decoded inline —
                # everything else defers to _fam_admission, the one place
                # that understands the cache layout.
                tg0 = cached[1]
                if tg0 is not None and cached[2] == tg0._gen:
                    ok = cached[0]
                else:
                    ok = self._fam_admission(gi, c.fam, cached[3])
                if not ok:
                    continue
            if self._probe_claim(pod, g, gi, c, ci):
                return True
        return False

    def _try_claims_mono(self, pod: Pod, g: _Group, gi: int) -> bool:
        """Monotone claim scan: every matched group is hostname
        anti-affinity, whose domains only fill during a solve — so every
        rejection reason in the probe (tolerance, family compat, the
        anti-affinity count, fit, minValues) is permanent, and the scan can
        pop rejected claims from a lazily-synced (count, rank, ci) heap
        exactly like the plain driver's _try_claims. This turns the
        O(pods x claims) probe storm on anti-affinity-heavy solves into
        O(pods + claims) amortized, with the same first-admitting claim as
        the host's full rescan."""
        claims = self.claims
        heap = self.gheaps[gi]
        synced = self.gsynced[gi]
        if synced < len(claims):
            for ci in range(synced, len(claims)):
                c = claims[ci]
                heapq.heappush(heap, (c.count, c.rank, ci))
            self.gsynced[gi] = len(claims)
        while heap:
            count, rank, ci = heap[0]
            c = claims[ci]
            if c.count != count or c.rank != rank:
                heapq.heapreplace(heap, (c.count, c.rank, ci))
                continue
            if self._probe_claim(pod, g, gi, c, ci):
                return True
            heapq.heappop(heap)
        return False

    def _open_memo_tokens(self, gi: int) -> Optional[list]:
        """Topology groups whose count generations validate a memoized
        opening of shape group `gi`, or None when the opening is
        memo-ineligible. Hostname spread/anti groups contribute no token:
        their verdict on a FRESH placeholder (occupancy 0) is structurally
        count-independent — guarded by the freshness flag. Hostname
        affinity groups and every non-hostname group are gen-tracked."""
        if self.strict_res or self.res_active or self.groups[gi].has_hostname:
            return None
        toks: list = []
        for tg in self.g_matched[gi]:
            if tg.key == wk.LABEL_HOSTNAME and tg.type != TYPE_AFFINITY:
                if not self._fresh_hostnames_safe:
                    return None
            else:
                toks.append(tg)
        return toks

    def _replay_open(self, pod: Pod, gi: int, outcomes: list) -> None:
        """Replay a validated opening: consume one placeholder per failing
        template attempt (host parity — the counter advances on every
        retry) and open the memoized claim on the successful one."""
        s = self.s
        for out in outcomes:
            if out is None:  # template attempt that drew and failed
                next(ncmod._hostname_counter)
                continue
            ti, fam, candidate, u_ids, rem0_fit, min_specs, min_relaxed = out
            hostname = f"hostname-placeholder-{next(ncmod._hostname_counter):04d}"
            self._open_claim(
                ti, fam, pod, gi, candidate, u_ids, rem0_fit.copy(),
                hostname=hostname, min_specs=min_specs, min_relaxed=min_relaxed,
                pareto=self._pareto_for(rem0_fit) if self._defer_ok else None,
            )
            if self._any_ports:
                nct = s.nodeclaim_templates[ti]
                gp = self.g_ports[gi]
                hp = s.daemon_hostports[nct].copy()
                if gp:
                    hp.add(pod, gp)
                self._claim_hp[len(self.claims) - 1] = hp
            self._apply_record_plan(gi, self.claims[-1])
            # no _subtract_max: memo eligibility requires limitless pools

    def _new_claim_topo(self, pod: Pod, g: _Group, gi: int) -> Optional[Exception]:
        """New-claim opening with host-identical hostname-counter consumption
        and topology narrowing (scheduler.go:478-556 + nodeclaim.go:114-163).
        No memoized ERROR short-circuit: the host re-runs the template loop
        (and consumes placeholder hostnames) on every retry, and hostname
        STRINGS are decision-relevant under sorted-domain iteration.
        SUCCESSFUL openings are memoized per shape group and replayed while
        the matched groups' count generations stand still — repeat openings
        (the dominant cost on anti-affinity-heavy solves, where claims
        saturate after a few pods) cost two dict hits and the placeholder
        draws instead of the full template loop."""
        memo = self._open_memo.get(gi)
        if memo is not None:
            toks, gens, outcomes = memo
            k = 0
            for tg in toks:
                if gens[k] != tg._gen:
                    break
                k += 1
            else:
                self._replay_open(pod, gi, outcomes)
                return None
        s, topo = self.s, self.topology
        gp = self.g_ports[gi]
        # (nodepool, error): the pool attribution feeds the explanation
        # funnel (observability/explain.py); the joined message is unchanged
        errs: list[tuple[str, Exception]] = []
        outcomes: list = []
        memo_ok = True
        # gens are captured at ENTRY: the memo is valid only while the
        # counts the evaluation below actually SAW stand still. The
        # opening's own records then invalidate it for the next open —
        # exactly when the next-domain choice could differ.
        memo_toks = self._open_memo_tokens(gi)
        entry_gens = (
            [tg._gen for tg in memo_toks] if memo_toks is not None else None
        )
        for ti, nct in enumerate(s.nodeclaim_templates):
            remaining = self.remaining_resources.get(nct.nodepool_name)
            limits_mask = None
            if remaining:
                # active limits shift per open; the opening memo only covers
                # limitless pools
                memo_ok = False
                limits_mask = self._limits_mask(nct.nodepool_name, remaining)
                if not (limits_mask & self.tmpl_mask[ti]).any():
                    errs.append(
                        (
                            nct.nodepool_name,
                            ValueError(
                                f"all available instance types exceed limits "
                                f"for nodepool {nct.nodepool_name!r}"
                            ),
                        )
                    )
                    continue
            # the host constructs the NodeClaim here, consuming a hostname
            # placeholder even when can_add then fails
            hostname = f"hostname-placeholder-{next(ncmod._hostname_counter):04d}"
            outcomes.append(None)  # assume draw-and-fail; success overwrites
            tol = self.tg_tol.get((ti, gi))
            if tol is None:
                tol = Taints(nct.spec.taints).tolerates_pod(pod) is None
                self.tg_tol[(ti, gi)] = tol
            if not tol:
                errs.append(
                    (
                        nct.nodepool_name,
                        ValueError(
                            str(Taints(nct.spec.taints).tolerates_pod(pod))
                        ),
                    )
                )
                continue
            if gp:
                conflict = s.daemon_hostports[nct].conflicts(pod, gp)
                if conflict is not None:
                    errs.append(
                        (
                            nct.nodepool_name,
                            ValueError(f"checking host port usage, {conflict}"),
                        )
                    )
                    continue
            if g.has_hostname:
                # the host's compat gate runs with the claim's placeholder
                # hostname row included (nodeclaim.go:285-291) — reproduce
                # its exact error text, placeholder string and all
                claim_reqs = Requirements(*nct.requirements.values())
                claim_reqs.add(
                    Requirement(wk.LABEL_HOSTNAME, Operator.IN, [hostname])
                )
                cerr = claim_reqs.compatible(
                    g.reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS
                )
                if cerr is not None:
                    errs.append(
                        (
                            nct.nodepool_name,
                            ValueError(f"incompatible requirements, {cerr}"),
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
            joint_tg, _rows = tg
            joint = Requirements(*joint_tg.values())
            joint.add(Requirement(wk.LABEL_HOSTNAME, Operator.IN, [hostname]))
            try:
                topo_reqs = topo.add_requirements(
                    pod,
                    nct.spec.taints,
                    g.strict_reqs,
                    joint,
                    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
                )
            except ValueError as e:
                errs.append((nct.nodepool_name, e))
                continue
            topo_err = joint.compatible(topo_reqs, ALLOW_UNDEFINED_WELL_KNOWN_LABELS)
            if topo_err is not None:
                errs.append((nct.nodepool_name, ValueError(topo_err)))
                continue
            joint.add(*topo_reqs.values())
            final_rows = self._rows_sans_hostname(joint)
            compat_v, offer_v = self._joint_masks(final_rows, joint)
            base = self.tmpl_mask[ti]
            if limits_mask is not None:
                base = base & limits_mask
            candidate = base & compat_v & offer_v
            cand_u = np.unique(self.uid_of_type[candidate])
            rem0 = self.uniq_alloc[cand_u] - (self.usage0_f[ti] + g.req_f)
            fitrows = (rem0 >= -_EPS).all(axis=1)
            if not fitrows.any():
                errs.append(
                    (
                        nct.nodepool_name,
                        self._filter_error(base, compat_v, offer_v, ti, g),
                    )
                )
                continue
            u_ids = cand_u[fitrows]
            final = self._final_types(candidate, u_ids)
            min_specs, min_relaxed = self.tmpl_min[ti], False
            if self.min_active and self.tmpl_min[ti]:
                min_specs, min_relaxed, msg = self._min_open(ti, final)
                if msg is not None:
                    err = self._filter_error(base, compat_v, offer_v, ti, g)
                    err.min_values_incompatible = msg
                    errs.append((nct.nodepool_name, err))
                    continue
            if self.strict_res:
                try:
                    self._pending_reserved = self._reserved_eval(
                        hostname, joint, final
                    )
                except ncmod.ReservedOfferingError as e:
                    # earliest-index-wins: the reserved error preempts later
                    # templates AND any collected errors (scheduler.go:574,
                    # 486-490 tail)
                    return e
            elif self.res_active:
                self._pending_reserved = None
            fam = self._intern_fam(final_rows, self._sans_hostname(joint))
            rem0_fit = rem0[fitrows]
            self._open_claim(
                ti, fam, pod, gi, candidate, u_ids, rem0_fit.copy(),
                hostname=hostname, min_specs=min_specs, min_relaxed=min_relaxed,
                pareto=self._pareto_for(rem0_fit) if self._defer_ok else None,
            )
            if self._any_ports:
                hp = s.daemon_hostports[nct].copy()
                if gp:
                    hp.add(pod, gp)
                self._claim_hp[len(self.claims) - 1] = hp
            self._apply_record_plan(gi, self.claims[-1])
            self._subtract_max(nct, final)
            if memo_ok and memo_toks is not None:
                outcomes[-1] = (
                    ti, fam, candidate, u_ids, rem0_fit,
                    min_specs, min_relaxed,
                )
                self._open_memo[gi] = (memo_toks, entry_gens, outcomes)
            return None
        from karpenter_tpu_torch.observability import explain as explmod

        rec = explmod.recorder()
        if rec.enabled and errs:
            # stage the per-nodepool funnel, exactly as the host scheduler
            # does (scheduler.py _add_to_new_node_claim) — the solve barrier
            # commits it only if the pod stays failed
            rec.note_funnel(pod.metadata.uid, explmod.funnel_from(errs))
        if not errs:
            errs.append(("", ValueError("no nodepool can host the pod")))
        return (
            errs[0][1]
            if len(errs) == 1
            else ValueError("; ".join(str(e) for _, e in errs))
        )

    def _restore_relaxed(self, pod: Pod) -> None:
        """Final-failure tail of a relax chain: restore the ORIGINAL pod's
        topology ownership and cached data (scheduler.go:363-367)."""
        self.topology.update(pod)
        self.s.update_cached_pod_data(pod)
        self._relax_restore.pop(pod.metadata.uid, None)

    # -- attempt / relax loop ------------------------------------------------

    def _try_once(self, pod: Pod, gi: int) -> Optional[Exception]:
        """One host `_add` pass: existing nodes → in-flight claims → new
        claim (scheduler.go:436-449)."""
        g = self.groups[gi]
        volatile = self.g_volatile[gi]
        if self.nodes:
            if volatile:
                placed = self._try_nodes_topo(pod, g, gi)
            else:
                placed = self._try_nodes(pod, g, gi)
                if placed and self._needs_record(gi):
                    nd = self._joined_node
                    self.topology.record(pod, nd.en.cached_taints, nd.reqs)
            if placed:
                return None
        if volatile:
            placed = self._try_claims_topo(pod, g, gi)
        else:
            placed = self._try_claims(pod, g, gi)
            if placed and self._needs_record(gi):
                self._apply_record_plan(gi, self._joined)
        if placed:
            return None
        if not self.s.nodeclaim_templates:
            return ValueError(
                "nodepool requirements filtered out all available instance types"
            )
        return self._new_claim_topo(pod, g, gi)

    def _attempt(self, pod: Pod, gi: int) -> Optional[Exception]:
        """Host `_try_schedule`: attempt, then relax one preference at a time
        on failure, topology.update + pod-data refresh between steps
        (scheduler.go:351-371). Final failure restores the original pod's
        ownership and cached data (scheduler.go:363-367 error tail)."""
        s = self.s
        p, pgi = pod, gi
        relaxed_any = False
        while True:
            err = self._try_once(p, pgi)
            if err is None:
                return None
            if isinstance(err, ncmod.ReservedOfferingError):
                # a new-claim reserved error preempts relaxation —
                # _try_schedule re-raises it (scheduler.go:374-375)
                if relaxed_any:
                    self._restore_relaxed(pod)
                return err
            if not self.g_relaxable[pgi]:
                if relaxed_any:
                    self._restore_relaxed(pod)
                return err
            rc = copy.deepcopy(p) if p is pod else p
            if not s.preferences.relax(rc):
                if relaxed_any:
                    self._restore_relaxed(pod)
                return err
            relaxed_any = True
            self._relax_restore.setdefault(pod.metadata.uid, pod)
            self.topology.update(rc)
            self._maybe_refresh_groups()
            s.update_cached_pod_data(rc)
            ngi = self._ensure_group(rc)
            if ngi is None:
                raise _Fallback("relaxed shape ineligible")
            p, pgi = rc, ngi

    # -- main loop -----------------------------------------------------------

    def run(self, timeout: Optional[float]) -> None:
        gi_arr = self._group_pods()
        if gi_arr is None:
            raise _IneligibleShape("ineligible pod shape")
        self._prepare_templates()
        # deferred row-pruning: legal whenever no per-join row reads exist —
        # minValues gates and reserved bookkeeping both read u_ids per join
        self._defer_ok = not (self.min_active or self.res_active)
        order = self._order(gi_arr)
        self._snapshot_topology()
        qpods = [(self.pods[i], int(gi_arr[i])) for i in order]
        head = 0
        last_len: dict[str, int] = {}
        pod_errors = self.pod_errors
        start = time.perf_counter()
        check = 0
        # fast-lane conditions hoisted out of the loop: with no existing
        # nodes and a non-relaxable shape, one attempt is exactly
        # claim-scan → new-claim (no _attempt/_try_once dispatch)
        relaxable = self.g_relaxable
        volatile = self.g_volatile
        has_nodes = bool(self.nodes)
        has_templates = bool(self.s.nodeclaim_templates)
        groups = self.groups
        while head < len(qpods):
            pod, gi = qpods[head]
            if last_len and last_len.get(pod.metadata.uid) == len(qpods) - head:
                break
            check += 1
            if timeout is not None and not (check & 0x3F):
                if time.perf_counter() - start > timeout:
                    self.timed_out = True
                    for p, _ in qpods[head:]:
                        pod_errors.setdefault(
                            p, TimeoutError("scheduling simulation timed out")
                        )
                    return
            head += 1
            if not has_nodes and not relaxable[gi] and has_templates and volatile[gi]:
                if self._try_claims_topo(pod, groups[gi], gi):
                    err = None
                else:
                    err = self._new_claim_topo(pod, groups[gi], gi)
            else:
                err = self._attempt(pod, gi)
            if err is None:
                if pod_errors:
                    pod_errors.pop(pod, None)
            else:
                pod_errors[pod] = err
                qpods.append((pod, gi))
                last_len[pod.metadata.uid] = len(qpods) - head

    def emit(self):
        super().emit()
        _TOPO_SOLVES_CTR.inc()
