"""Topology engine: topology-spread, pod-affinity and pod-anti-affinity.

Mirrors the reference's scheduling/topology.go (group tracking, inverse
anti-affinity, domain counting), topologygroup.go (per-group next-domain
selection), topologynodefilter.go and topologydomaingroup.go. Domain counts
are per-(group, domain) integers — the device packer aggregates the same
counts as scatter-add tensors (ops/packer.py); this host engine is the
semantic oracle.
"""

from __future__ import annotations

import copy
import itertools
from typing import Iterable, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import LabelSelector, Node, Pod, Taint
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Operator,
    Requirement,
    Requirements,
    requirements_from_dicts,
    strict_pod_requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as podutil

MAX_SKEW_UNBOUNDED = 1 << 31

TYPE_SPREAD = "topology spread"
TYPE_AFFINITY = "pod affinity"
TYPE_ANTI_AFFINITY = "pod anti-affinity"

HONOR = "Honor"
IGNORE = "Ignore"

PREFERENCE_POLICY_RESPECT = "Respect"
PREFERENCE_POLICY_IGNORE = "Ignore"

# Process-global generation source for TopologyGroup count state. Every
# domain-count mutation stamps the group with a FRESH value (never reused),
# so the device solver's count tensors (ops/topo_counts.py) can validate
# their sync with one integer compare — and a snapshot restore can't alias
# a stale tensor onto restored counts (the restored stamp is new too).
_count_gen = itertools.count(1)


def ignored_for_topology(p: Pod) -> bool:
    return not podutil.is_scheduled(p) or podutil.is_terminal(p) or podutil.is_terminating(p)


class TopologyNodeFilter:
    """Which nodes a topology group counts (topologynodefilter.go:27-85).

    For spread constraints this honors the pod's node affinity/taints per the
    NodeInclusionPolicy; affinity groups use the permissive zero value.
    """

    def __init__(
        self,
        requirements: Sequence[Requirements] = (),
        taint_policy: str = "",
        affinity_policy: str = "",
        tolerations: Sequence = (),
    ):
        self.requirements = list(requirements)
        self.taint_policy = taint_policy
        self.affinity_policy = affinity_policy
        self.tolerations = list(tolerations)

    @classmethod
    def for_spread(cls, pod: Pod, taint_policy: str, affinity_policy: str) -> "TopologyNodeFilter":
        selector_reqs = Requirements.from_labels(pod.spec.node_selector)
        aff = pod.spec.affinity
        terms = (
            aff.node_affinity.required
            if aff is not None and aff.node_affinity is not None
            else []
        )
        if not terms:
            reqs = [selector_reqs]
        else:
            reqs = []
            for term in terms:
                r = Requirements()
                r.add(*selector_reqs.values())
                r.add(*requirements_from_dicts(term.match_expressions).values())
                reqs.append(r)
        return cls(reqs, taint_policy, affinity_policy, pod.spec.tolerations)

    def matches(
        self,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: frozenset[str] = frozenset(),
    ) -> bool:
        matches_affinity = True
        if self.affinity_policy == HONOR:
            matches_affinity = self._matches_requirements(requirements, allow_undefined)
        matches_taints = True
        if self.taint_policy == HONOR:
            if Taints(taints).tolerates(self.tolerations) is not None:
                matches_taints = False
        return matches_affinity and matches_taints

    def _matches_requirements(
        self, requirements: Requirements, allow_undefined: frozenset[str]
    ) -> bool:
        if not self.requirements or self.affinity_policy == IGNORE:
            return True
        return any(
            requirements.compatible(req, allow_undefined) is None
            for req in self.requirements
        )

    def hash_key(self) -> tuple:
        return (
            tuple(sorted(repr(r) for r in self.requirements)),
            self.taint_policy,
            self.affinity_policy,
            tuple(sorted((t.key, t.operator, t.value, t.effect) for t in self.tolerations)),
        )


class TopologyDomainGroup(dict):
    """domain -> list of nodepool taint-sets able to host it
    (topologydomaingroup.go:26-56)."""

    def insert(self, domain: str, taints: Sequence[Taint]) -> None:
        if domain not in self or len(taints) == 0:
            self[domain] = [list(taints)]
            return
        if len(self[domain][0]) == 0:
            return  # already reachable taint-free
        self[domain].append(list(taints))

    def for_each_domain(self, pod: Pod, taint_policy: str, fn) -> None:
        for domain, taint_groups in self.items():
            if taint_policy == IGNORE:
                fn(domain)
                continue
            for taints in taint_groups:
                if Taints(taints).tolerates_pod(pod) is None:
                    fn(domain)
                    break


class TopologyGroup:
    def __init__(
        self,
        type_: str,
        key: str,
        pod: Pod,
        namespaces: set[str],
        selector: Optional[LabelSelector],
        max_skew: int,
        min_domains: Optional[int],
        taint_policy: Optional[str],
        affinity_policy: Optional[str],
        domain_group: TopologyDomainGroup,
    ):
        self.type = type_
        self.key = key
        self.namespaces = namespaces
        self.selector = selector
        self.max_skew = max_skew
        self.min_domains = min_domains
        if type_ == TYPE_SPREAD:
            self.node_filter = TopologyNodeFilter.for_spread(
                pod, taint_policy or IGNORE, affinity_policy or HONOR
            )
        else:
            self.node_filter = TopologyNodeFilter()
        self.owners: set[str] = set()
        self.domains: dict[str, int] = {}
        self.empty_domains: set[str] = set()
        self._gen = next(_count_gen)  # count-state generation (see _count_gen)
        self._domain_reqs: dict[str, Requirement] = {}
        self._anti_reqs: dict[str, Requirement] = {}
        self._empty_anti: Optional[Requirement] = None
        domain_group.for_each_domain(pod, self.node_filter.taint_policy, self._seed)

    def _seed(self, domain: str) -> None:
        self.domains[domain] = 0
        self.empty_domains.add(domain)

    # -- bookkeeping --------------------------------------------------------

    def record(self, *domains: str) -> None:
        for d in domains:
            self.domains[d] = self.domains.get(d, 0) + 1
            self.empty_domains.discard(d)
        if domains:
            self._gen = next(_count_gen)

    def register(self, *domains: str) -> None:
        changed = False
        for d in domains:
            if d not in self.domains:
                self.domains[d] = 0
                self.empty_domains.add(d)
                changed = True
        if changed:
            self._gen = next(_count_gen)

    def unregister(self, *domains: str) -> None:
        changed = False
        for d in domains:
            if self.domains.pop(d, None) is not None:
                changed = True
            self.empty_domains.discard(d)
        if changed:
            self._gen = next(_count_gen)

    def add_owner(self, uid: str) -> None:
        self.owners.add(uid)

    def remove_owner(self, uid: str) -> None:
        self.owners.discard(uid)

    def is_owned_by(self, uid: str) -> bool:
        return uid in self.owners

    def selects(self, pod: Pod) -> bool:
        if pod.metadata.namespace not in self.namespaces:
            return False
        if self.selector is None:
            return False
        return self.selector.matches(pod.metadata.labels)

    def counts(
        self,
        pod: Pod,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: frozenset[str] = frozenset(),
    ) -> bool:
        return self.selects(pod) and self.node_filter.matches(
            taints, requirements, allow_undefined
        )

    def hash_key(self) -> tuple:
        selector_key = None
        if self.selector is not None:
            selector_key = (
                tuple(sorted(self.selector.match_labels.items())),
                tuple(
                    (e["key"], e["operator"], tuple(sorted(e.get("values", []))))
                    for e in self.selector.match_expressions
                ),
            )
        return (
            self.type,
            self.key,
            frozenset(self.namespaces),
            selector_key,
            self.max_skew,
            self.node_filter.hash_key(),
        )

    # -- next-domain selection (topologygroup.go:205-408) -------------------

    def get(self, pod: Pod, pod_domains: Requirement, node_domains: Requirement) -> Requirement:
        if self.type == TYPE_SPREAD:
            return self._next_domain_spread(pod, pod_domains, node_domains)
        if self.type == TYPE_AFFINITY:
            return self._next_domain_affinity(pod, pod_domains, node_domains)
        return self._next_domain_anti_affinity(pod_domains, node_domains)

    def _single_domain(self, domain: str) -> Requirement:
        """Cached `key In [domain]` result rows — the hot return of spread
        selection; callers never mutate returned requirements."""
        req = self._domain_reqs.get(domain)
        if req is None:
            req = Requirement(self.key, Operator.IN, [domain])
            self._domain_reqs[domain] = req
        return req

    def _next_domain_spread(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        min_count = self._domain_min_count(pod_domains)
        self_selecting = self.selects(pod)

        # Hostname fast path: a single-hostname target either satisfies skew
        # or the group forbids the key entirely (topologygroup.go:215-227).
        # Gated on a non-complement row like the reference's Operator==In
        # check: a single-value NotIn names the EXCLUDED hostname.
        if (
            self.key == wk.LABEL_HOSTNAME
            and not node_domains.complement
            and len(node_domains.values) == 1
        ):
            hostname = next(iter(node_domains.values))
            count = self.domains.get(hostname, 0)
            if self_selecting:
                count += 1
            if count <= self.max_skew:
                return self._single_domain(hostname)
            return Requirement(self.key, Operator.DOES_NOT_EXIST)

        best_domain = None
        best_count = MAX_SKEW_UNBOUNDED
        if node_domains.operator == Operator.IN:
            candidates = [d for d in node_domains.values_list() if d in self.domains]
        else:
            candidates = sorted(d for d in self.domains if node_domains.has(d))
        for domain in candidates:
            count = self.domains[domain]
            if self_selecting:
                count += 1
            if count - min_count <= self.max_skew and count < best_count:
                best_domain = domain
                best_count = count
        if best_domain is None:
            return Requirement(self.key, Operator.DOES_NOT_EXIST)
        return self._single_domain(best_domain)

    def _domain_min_count(self, domains: Requirement) -> int:
        # Hostname spread can always create a fresh empty domain
        # (topologygroup.go:269-273).
        if self.key == wk.LABEL_HOSTNAME:
            return 0
        # unconstrained pod domains (Exists): every domain is supported
        if (
            domains.complement
            and not domains.values
            and domains.greater_than is None
            and domains.less_than is None
        ):
            supported = len(self.domains)
            min_count = min(self.domains.values()) if supported else MAX_SKEW_UNBOUNDED
        else:
            min_count = MAX_SKEW_UNBOUNDED
            supported = 0
            for domain, count in self.domains.items():
                if domains.has(domain):
                    supported += 1
                    if count < min_count:
                        min_count = count
        if self.min_domains is not None and supported < self.min_domains:
            min_count = 0
        return min_count

    def _next_domain_affinity(
        self, pod: Pod, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        options = Requirement(self.key, Operator.DOES_NOT_EXIST)

        if (
            self.key == wk.LABEL_HOSTNAME
            and not node_domains.complement
            and len(node_domains.values) == 1
        ):
            hostname = next(iter(node_domains.values))
            if not pod_domains.has(hostname):
                return options
            if self.domains.get(hostname, 0) > 0:
                options.insert(hostname)
                return options
            if self.selects(pod) and (
                len(self.domains) == len(self.empty_domains)
                or not self._any_compatible_pod_domain(pod_domains)
            ):
                options.insert(hostname)
            return options

        if node_domains.operator == Operator.IN:
            for domain in node_domains.values_list():
                if pod_domains.has(domain) and self.domains.get(domain, 0) > 0:
                    options.insert(domain)
        else:
            for domain in sorted(self.domains):
                if pod_domains.has(domain) and self.domains[domain] > 0 and node_domains.has(domain):
                    options.insert(domain)
        if len(options.values) != 0:
            return options

        # The pod can self-satisfy its affinity: if nothing currently matches
        # anywhere (or no compatible domain has a match), seed a domain
        # (topologygroup.go:322-343).
        if self.selects(pod) and (
            len(self.domains) == len(self.empty_domains)
            or not self._any_compatible_pod_domain(pod_domains)
        ):
            intersected = pod_domains.intersection(node_domains)
            for domain in sorted(self.domains):
                if intersected.has(domain):
                    options.insert(domain)
                    break
            for domain in sorted(self.domains):
                if pod_domains.has(domain):
                    options.insert(domain)
                    break
        return options

    def _any_compatible_pod_domain(self, pod_domains: Requirement) -> bool:
        return any(
            pod_domains.has(domain) and count > 0
            for domain, count in self.domains.items()
        )

    def _next_domain_anti_affinity(
        self, pod_domains: Requirement, node_domains: Requirement
    ) -> Requirement:
        # hostname fast path, allocation-free: this runs once per
        # (pod, claim) probe — O(pods x claims) on anti-affinity-heavy
        # solves — so the returned requirements are cached shared objects
        # (callers never mutate returned requirements, as with
        # _single_domain) and the sorted values_list() is avoided
        if (
            self.key == wk.LABEL_HOSTNAME
            and not node_domains.complement
            and len(node_domains.values) == 1
        ):
            hostname = next(iter(node_domains.values))
            if self.domains.get(hostname, 0) != 0:
                empty = self._empty_anti
                if empty is None:
                    empty = self._empty_anti = Requirement(
                        self.key, Operator.DOES_NOT_EXIST
                    )
                return empty
            req = self._anti_reqs.get(hostname)
            if req is None:
                req = Requirement(self.key, Operator.DOES_NOT_EXIST)
                req.insert(hostname)
                self._anti_reqs[hostname] = req
            return req

        options = Requirement(self.key, Operator.DOES_NOT_EXIST)

        if (
            node_domains.operator == Operator.IN
            and len(node_domains.values_list()) < len(self.empty_domains)
        ):
            for domain in node_domains.values_list():
                if domain in self.empty_domains and pod_domains.has(domain):
                    options.insert(domain)
        else:
            for domain in sorted(self.empty_domains):
                if node_domains.has(domain) and pod_domains.has(domain):
                    options.insert(domain)
        return options

    def __repr__(self) -> str:
        return f"TopologyGroup({self.type}, key={self.key}, domains={self.domains})"


def _sel_key(sel: Optional[LabelSelector]) -> Optional[tuple]:
    if sel is None:
        return None
    return (
        tuple(sorted(sel.match_labels.items())),
        tuple(
            (e["key"], e["operator"], tuple(e.get("values", ())))
            for e in sel.match_expressions
        ),
    )


def _aff_term_key(term) -> tuple:
    return (
        term.topology_key,
        _sel_key(term.label_selector),
        tuple(term.namespaces),
        _sel_key(term.namespace_selector),
    )


def _pod_shape_key(p: Pod) -> tuple:
    """Value key over every pod field that shapes its topology groups:
    namespace + labels (matchLabelKeys, selects), node selector / required
    node affinity / tolerations (the spread node filter), and the spread +
    pod (anti-)affinity constraint content.

    Cached on the pod object (pods persist across provisioner passes, and
    Topology is rebuilt every batch — the key is the dominant cost of that
    rebuild at 20k+ pods). Every in-place spec mutation site must invalidate
    `_kt_topo_key` alongside the other shape-signature caches
    (scheduler/preferences.py relax, scheduler/volumetopology.py inject)."""
    cached = getattr(p, "_kt_topo_key", None)
    if cached is not None:
        return cached
    key = _pod_shape_key_compute(p)
    try:
        p._kt_topo_key = key
    except Exception:  # noqa: BLE001 — slotted/frozen pod
        pass
    return key


def _pod_shape_key_compute(p: Pod) -> tuple:
    spec = p.spec
    aff = spec.affinity
    na_sig: tuple = ()
    pa_sig: tuple = ()
    panti_sig: tuple = ()
    if aff is not None:
        if aff.node_affinity is not None:
            na_sig = tuple(
                tuple(
                    (e["key"], e["operator"], tuple(e.get("values", ())))
                    for e in t.match_expressions
                )
                for t in aff.node_affinity.required
            )
        if aff.pod_affinity is not None:
            pa_sig = (
                tuple(_aff_term_key(t) for t in aff.pod_affinity.required),
                tuple(
                    (w.weight, _aff_term_key(w.pod_affinity_term))
                    for w in aff.pod_affinity.preferred
                ),
            )
        if aff.pod_anti_affinity is not None:
            panti_sig = (
                tuple(_aff_term_key(t) for t in aff.pod_anti_affinity.required),
                tuple(
                    (w.weight, _aff_term_key(w.pod_affinity_term))
                    for w in aff.pod_anti_affinity.preferred
                ),
            )
    # group construction reads only the labels named in matchLabelKeys
    # (topology.go:437-448); hashing the full label map would defeat the
    # memo for workloads with per-pod-unique labels
    mlk_labels = tuple(
        sorted(
            (k, p.metadata.labels.get(k))
            for t in spec.topology_spread_constraints
            for k in t.match_label_keys
        )
    )
    return (
        p.metadata.namespace,
        mlk_labels,
        tuple(sorted(spec.node_selector.items())) if spec.node_selector else (),
        tuple((t.key, t.operator, t.value, t.effect) for t in spec.tolerations),
        tuple(
            (
                t.topology_key,
                t.max_skew,
                t.when_unsatisfiable,
                _sel_key(t.label_selector),
                t.min_domains,
                t.node_affinity_policy,
                t.node_taints_policy,
                tuple(t.match_label_keys),
            )
            for t in spec.topology_spread_constraints
        ),
        na_sig,
        pa_sig,
        panti_sig,
    )


_domain_groups_cache: dict[tuple, dict] = {}
_DOMAIN_CACHE_CAP = 16


def build_domain_groups(
    node_pools: Sequence[NodePool], instance_types: dict
) -> dict[str, TopologyDomainGroup]:
    """Domain universe per topology key from nodepool ∩ instance-type
    requirements (topology.go:94-131).

    Memoized per (nodepool uid+version, catalog list identity): the scan is
    O(nodepools × instance types × requirement rows) and its inputs only
    change on nodepool updates or catalog refreshes, while the provisioner
    rebuilds topology every batch. The result is treated as immutable by
    all readers."""
    try:
        # instance-type ELEMENT identities, not the wrapper list's (providers
        # hand back a fresh list per call around stable InstanceType objects)
        key = tuple(
            (
                np.metadata.uid,
                np.metadata.resource_version,
                tuple(map(id, instance_types.get(np.metadata.name) or ())),
            )
            for np in node_pools
        )
    except (AttributeError, TypeError):
        key = None
    if key is not None:
        hit = _domain_groups_cache.get(key)
        if hit is not None:
            return hit[0]
    domain_groups: dict[str, TopologyDomainGroup] = {}
    for np in node_pools:
        its = instance_types.get(np.metadata.name, [])
        taints = np.spec.template.spec.taints
        base = Requirements()
        base.add(*requirements_from_dicts(np.spec.template.spec.requirements).values())
        base.add(*Requirements.from_labels(np.spec.template.labels).values())
        for it in its:
            reqs = base.copy()
            reqs.add(*it.requirements.values())
            for req in reqs:
                group = domain_groups.setdefault(req.key, TopologyDomainGroup())
                for domain in req.values_list():
                    group.insert(domain, taints)
        for req in base:
            if req.operator == Operator.IN:
                group = domain_groups.setdefault(req.key, TopologyDomainGroup())
                for domain in req.values_list():
                    group.insert(domain, taints)
    if key is not None:
        if len(_domain_groups_cache) >= _DOMAIN_CACHE_CAP:
            _domain_groups_cache.clear()
        # the entry holds the instance-type lists so their id()s (part of
        # the key) cannot be recycled onto different content while cached
        _domain_groups_cache[key] = (
            domain_groups,
            [instance_types.get(np.metadata.name) for np in node_pools],
        )
    return domain_groups


class Topology:
    def __init__(
        self,
        store: Store,
        cluster: Cluster,
        state_nodes: Sequence[StateNode],
        node_pools: Sequence[NodePool],
        instance_types: dict,
        pods: Sequence[Pod],
        preference_policy: str = PREFERENCE_POLICY_RESPECT,
    ):
        self.store = store
        self.cluster = cluster
        self.state_nodes = list(state_nodes)
        self.preference_policy = preference_policy
        self.domain_groups = build_domain_groups(node_pools, instance_types)
        self.topology_groups: dict[tuple, TopologyGroup] = {}
        self.inverse_topology_groups: dict[tuple, TopologyGroup] = {}
        # group-construction memo: pods with value-identical constraint
        # content resolve to the same (deduped) groups; keyed over every
        # input _new_for_topologies/_new_for_affinities reads (namespace,
        # labels via matchLabelKeys/selects, selector/affinity/tolerations
        # via the spread node filter, and the constraint terms themselves)
        self._shape_groups: dict[tuple, list[TopologyGroup]] = {}
        # per-shape flag: does update() run the inverse anti-affinity
        # bookkeeping for this shape? (the __init__ fast path replays it
        # per pod — it registers per-uid ownership)
        self._shape_inverse: dict[tuple, bool] = {}
        # Pods being scheduled are excluded from live-cluster counting — the
        # simulation itself records them (topology.go:78-80). The set is
        # materialized lazily (see the excluded_pods property): plain solves
        # never consult it, and building 100k uids per batch is measurable.
        self._batch_pods = pods
        self._excluded_pods: Optional[set[str]] = None
        self._update_inverse_affinities()
        shape_groups = self._shape_groups
        shape_inverse = self._shape_inverse
        for p in pods:
            # plain pods (no spread constraints, no affinity) can neither
            # create nor own topology groups — skipping them keeps the init
            # scan O(1) per pod on large batches (the verdict is cached on
            # the pod; spec-mutation sites invalidate it like the other
            # shape caches). Each pod is seen exactly once here, so the
            # remove-owner sweep update() runs for re-relaxed pods is
            # skipped (fresh=True). Pods whose shape already passed through
            # update() take the memo fast path: ownership registration only
            # (plus the per-pod inverse anti-affinity bookkeeping for
            # shapes that need it).
            if getattr(p, "_kt_topo_plain", False):
                continue
            spec = p.spec
            if not spec.topology_spread_constraints and spec.affinity is None:
                try:
                    p._kt_topo_plain = True
                except Exception:  # noqa: BLE001 — slotted/frozen pod
                    pass
                continue
            key = getattr(p, "_kt_topo_key", None)
            owned = shape_groups.get(key) if key is not None else None
            if owned is None or key not in shape_inverse:
                self.update(p, fresh=True)
                continue
            if shape_inverse[key]:
                self._update_inverse_anti_affinity(p, None)
            uid = p.metadata.uid
            for tg in owned:
                tg.add_owner(uid)

    @property
    def excluded_pods(self) -> set[str]:
        s = self._excluded_pods
        if s is None:
            s = self._excluded_pods = {
                p.metadata.uid for p in self._batch_pods
            }
        return s

    # -- group construction (topology.go:143-169, 432-474) ------------------

    def update(self, p: Pod, fresh: bool = False) -> None:
        if not fresh:
            for tg in self.topology_groups.values():
                tg.remove_owner(p.metadata.uid)

        needs_inverse = (
            self.preference_policy == PREFERENCE_POLICY_IGNORE
            and podutil.has_required_pod_anti_affinity(p)
        ) or (
            self.preference_policy == PREFERENCE_POLICY_RESPECT
            and podutil.has_pod_anti_affinity(p)
        )
        if needs_inverse:
            self._update_inverse_anti_affinity(p, None)

        memo_key = _pod_shape_key(p)
        self._shape_inverse[memo_key] = needs_inverse
        owned = self._shape_groups.get(memo_key)
        if owned is None:
            owned = []
            for tg in self._new_for_topologies(p) + self._new_for_affinities(p):
                key = tg.hash_key()
                existing = self.topology_groups.get(key)
                if existing is None:
                    self._count_domains(tg)
                    self.topology_groups[key] = tg
                else:
                    tg = existing
                owned.append(tg)
            self._shape_groups[memo_key] = owned
        for tg in owned:
            tg.add_owner(p.metadata.uid)

    def _new_for_topologies(self, p: Pod) -> list[TopologyGroup]:
        out = []
        for tsc in p.spec.topology_spread_constraints:
            if (
                self.preference_policy == PREFERENCE_POLICY_IGNORE
                and tsc.when_unsatisfiable != "DoNotSchedule"
            ):
                continue
            # A nil selector stays nil (matches nothing, like labels.Nothing())
            # unless matchLabelKeys adds expressions (topology.go:437-448);
            # the copy is only needed when expressions are appended — groups
            # never mutate their selector, so sharing is safe otherwise
            selector = tsc.label_selector
            extra = [
                {"key": key, "operator": "In", "values": [p.metadata.labels[key]]}
                for key in tsc.match_label_keys
                if key in p.metadata.labels
            ]
            if extra:
                selector = copy.deepcopy(selector) or LabelSelector()
                selector.match_expressions.extend(extra)
            out.append(
                TopologyGroup(
                    TYPE_SPREAD,
                    tsc.topology_key,
                    p,
                    {p.metadata.namespace},
                    selector,
                    tsc.max_skew,
                    tsc.min_domains,
                    tsc.node_taints_policy,
                    tsc.node_affinity_policy,
                    self.domain_groups.get(tsc.topology_key, TopologyDomainGroup()),
                )
            )
        return out

    def _new_for_affinities(self, p: Pod) -> list[TopologyGroup]:
        out = []
        aff = p.spec.affinity
        if aff is None:
            return out
        terms: list[tuple[str, object]] = []
        if aff.pod_affinity is not None:
            for term in aff.pod_affinity.required:
                terms.append((TYPE_AFFINITY, term))
            if self.preference_policy == PREFERENCE_POLICY_RESPECT:
                for wterm in aff.pod_affinity.preferred:
                    terms.append((TYPE_AFFINITY, wterm.pod_affinity_term))
        if aff.pod_anti_affinity is not None:
            for term in aff.pod_anti_affinity.required:
                terms.append((TYPE_ANTI_AFFINITY, term))
            if self.preference_policy == PREFERENCE_POLICY_RESPECT:
                for wterm in aff.pod_anti_affinity.preferred:
                    terms.append((TYPE_ANTI_AFFINITY, wterm.pod_affinity_term))
        for type_, term in terms:
            out.append(
                TopologyGroup(
                    type_,
                    term.topology_key,
                    p,
                    self._build_namespace_list(
                        p.metadata.namespace, term.namespaces, term.namespace_selector
                    ),
                    term.label_selector,
                    MAX_SKEW_UNBOUNDED,
                    None,
                    None,
                    None,
                    self.domain_groups.get(term.topology_key, TopologyDomainGroup()),
                )
            )
        return out

    def _build_namespace_list(
        self, namespace: str, namespaces: list[str], selector: Optional[LabelSelector]
    ) -> set[str]:
        if not namespaces and selector is None:
            return {namespace}
        if selector is None:
            return set(namespaces)
        selected = {
            ns.metadata.name
            for ns in self.store.list("Namespace")
            if selector.matches(ns.metadata.labels)
        }
        return selected | set(namespaces)

    # -- inverse anti-affinity (topology.go:278-326) ------------------------

    def _update_inverse_affinities(self) -> None:
        def visit(pod: Pod, node: Node) -> bool:
            if pod.metadata.uid in self.excluded_pods:
                return True
            self._update_inverse_anti_affinity(pod, node.metadata.labels)
            return True

        self.cluster.for_pods_with_anti_affinity(visit)

    def _update_inverse_anti_affinity(
        self, pod: Pod, domains: Optional[dict[str, str]]
    ) -> None:
        """Track anti-affinities of EXISTING pods: a new node in their
        domains must not host pods they repel (topology.go:55-58, 304-326)."""
        for term in pod.spec.affinity.pod_anti_affinity.required:
            tg = TopologyGroup(
                TYPE_ANTI_AFFINITY,
                term.topology_key,
                pod,
                self._build_namespace_list(
                    pod.metadata.namespace, term.namespaces, term.namespace_selector
                ),
                term.label_selector,
                MAX_SKEW_UNBOUNDED,
                None,
                None,
                None,
                self.domain_groups.get(term.topology_key, TopologyDomainGroup()),
            )
            key = tg.hash_key()
            existing = self.inverse_topology_groups.get(key)
            if existing is None:
                self.inverse_topology_groups[key] = tg
            else:
                tg = existing
            if domains and tg.key in domains:
                tg.record(domains[tg.key])
            tg.add_owner(pod.metadata.uid)

    # -- live-cluster domain counting (topology.go:328-426) -----------------

    def _count_domains(self, tg: TopologyGroup) -> None:
        pods = []
        for ns in tg.namespaces:
            # A nil selector lists everything here, mirroring
            # TopologyListOptions (topology.go:466-471) — even though
            # selects() treats nil as matching nothing.
            pods.extend(
                self.store.list(
                    "Pod",
                    namespace=ns,
                    predicate=lambda p: tg.selector is None
                    or tg.selector.matches(p.metadata.labels),
                )
            )

        for sn in self.state_nodes:
            if sn.node is None:
                continue
            if not tg.node_filter.matches(
                sn.node.spec.taints, Requirements.from_labels(sn.node.metadata.labels)
            ):
                continue
            domain = sn.labels().get(tg.key)
            if domain is not None:
                tg.register(domain)

        pods.sort(key=lambda p: p.spec.node_name)
        node_cache: dict[str, Optional[Node]] = {}
        for p in pods:
            if ignored_for_topology(p):
                continue
            if p.metadata.uid in self.excluded_pods:
                continue
            node = node_cache.get(p.spec.node_name)
            if node is None and p.spec.node_name not in node_cache:
                node = self.store.try_get("Node", p.spec.node_name)
                node_cache[p.spec.node_name] = node
            if node is None:
                continue
            domain = node.metadata.labels.get(tg.key)
            if domain is None and tg.key == wk.LABEL_HOSTNAME:
                domain = node.metadata.name
            if domain is None:
                continue  # node without the domain label doesn't count
            if not tg.node_filter.matches(
                node.spec.taints, Requirements.from_labels(node.metadata.labels)
            ):
                continue
            tg.record(domain)

    # -- solver interface (topology.go:171-219, 252-276) --------------------

    def record(
        self,
        p: Pod,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: frozenset[str] = frozenset(),
    ) -> None:
        for tg in self.topology_groups.values():
            if tg.counts(p, taints, requirements, allow_undefined):
                domains = requirements.get(tg.key)
                if tg.type == TYPE_ANTI_AFFINITY:
                    tg.record(*domains.values_list())
                # cardinality 1 — complement sets (NotIn) are infinite and
                # must NOT record their excluded value (Len(), not Values())
                elif len(domains) == 1:
                    tg.record(domains.values_list()[0])
        for tg in self.inverse_topology_groups.values():
            if tg.is_owned_by(p.metadata.uid):
                tg.record(*requirements.get(tg.key).values_list())

    def add_requirements(
        self,
        p: Pod,
        taints: Iterable[Taint],
        pod_requirements: Requirements,
        node_requirements: Requirements,
        allow_undefined: frozenset[str] = frozenset(),
    ) -> Requirements:
        """Tighten node requirements with each matching group's next-domain
        choice; raises ValueError when a group admits no domain."""
        requirements = Requirements(*node_requirements.values())
        for tg in self._matching_topologies(p, taints, node_requirements, allow_undefined):
            pod_domains = (
                pod_requirements.get(tg.key)
                if pod_requirements.has(tg.key)
                else Requirement(tg.key, Operator.EXISTS)
            )
            node_domains = (
                node_requirements.get(tg.key)
                if node_requirements.has(tg.key)
                else Requirement(tg.key, Operator.EXISTS)
            )
            domains = tg.get(p, pod_domains, node_domains)
            if len(domains.values) == 0 and not domains.complement:
                raise ValueError(
                    f"unsatisfiable topology constraint for {tg.type}, "
                    f"key={tg.key} (counts={tg.domains}, podDomains={pod_domains!r}, "
                    f"nodeDomains={node_domains!r})"
                )
            requirements.add(domains)
        return requirements

    # -- count snapshot / rollback (device-solver contract) -----------------
    #
    # The device fast path (ops/ffd_topo.py) mutates live group counts and
    # ownership during its simulation; a fallback abort must hand the host
    # loop EXACTLY the pre-solve state. The contract: snapshot_counts()
    # before the first mutation, restore_counts() on abort. Restoring stamps
    # every group with a FRESH generation so device count tensors synced
    # mid-solve (ops/topo_counts.py) can never alias the rolled-back counts.

    def snapshot_counts(self) -> tuple:
        """Snapshot per-group domain counts plus the group dictionaries
        themselves — relaxation can CREATE groups mid-solve (a relaxed
        shape's node-filter hash differs), and a pure host run would
        re-create them with fresh counts, so rollback removes them."""
        return (
            [
                (tg, dict(tg.domains), set(tg.empty_domains))
                for tg in (
                    list(self.topology_groups.values())
                    + list(self.inverse_topology_groups.values())
                )
            ],
            dict(self.topology_groups),
            dict(self.inverse_topology_groups),
            dict(self._shape_groups),
        )

    def restore_counts(self, snapshot: tuple) -> None:
        counts, groups, inverse, shapes = snapshot
        self.topology_groups = dict(groups)
        self.inverse_topology_groups = dict(inverse)
        self._shape_groups = dict(shapes)
        for tg, domains, empty in counts:
            tg.domains = domains
            tg.empty_domains = empty
            tg._gen = next(_count_gen)
        # (this package keeps no solver residency across solves, so a
        # rollback has nothing further to invalidate)

    def register(self, topology_key: str, domain: str) -> None:
        for tg in self.topology_groups.values():
            if tg.key == topology_key:
                tg.register(domain)
        for tg in self.inverse_topology_groups.values():
            if tg.key == topology_key:
                tg.register(domain)

    def unregister(self, topology_key: str, domain: str) -> None:
        for tg in self.topology_groups.values():
            if tg.key == topology_key:
                tg.unregister(domain)
        for tg in self.inverse_topology_groups.values():
            if tg.key == topology_key:
                tg.unregister(domain)

    def _matching_topologies(
        self,
        p: Pod,
        taints: Iterable[Taint],
        requirements: Requirements,
        allow_undefined: frozenset[str],
    ) -> list[TopologyGroup]:
        out = [
            tg for tg in self.topology_groups.values() if tg.is_owned_by(p.metadata.uid)
        ]
        out.extend(
            tg
            for tg in self.inverse_topology_groups.values()
            if tg.counts(p, taints, requirements, allow_undefined)
        )
        return out
