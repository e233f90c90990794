"""Disruption helpers: SimulateScheduling, candidate discovery, budgets.

Mirrors the reference's disruption/helpers.go:50-281.
"""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Callable, Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.cloudprovider.types import CloudProvider, InstanceType
from karpenter_tpu_torch.controllers.disruption.types import Candidate, new_candidate
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduler.scheduler import Results
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode, active, deleting
from karpenter_tpu_torch.utils import nodepool as nodepoolutil
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.pdb import Limits
from karpenter_tpu_torch.operator import logging as klog

if TYPE_CHECKING:
    from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner

_ALLOWED_DISRUPTIONS = global_registry.gauge(
    "karpenter_nodepools_allowed_disruptions",
    "allowed disruptions per nodepool/reason",
    labels=["nodepool", "reason"],
)


class CandidateDeletingError(Exception):
    """A candidate started deleting mid-simulation (helpers.go:47)."""


class UninitializedNodeError(Exception):
    """Simulation placed a pod on an uninitialized node (helpers.go:143-160)."""


def simulate_scheduling(
    store: Store,
    cluster: Cluster,
    provisioner: "Provisioner",
    *candidates: Candidate,
) -> Results:
    """Re-run the provisioning solver with the candidates' nodes removed and
    their reschedulable pods pending (helpers.go:50-141)."""
    candidate_names = {c.name() for c in candidates}
    nodes = cluster.state_nodes()
    deleting_nodes = deleting(nodes)
    state_nodes = [n for n in active(nodes) if n.name() not in candidate_names]
    if any(n.name() in candidate_names for n in deleting_nodes):
        raise CandidateDeletingError()

    pods = provisioner.get_pending_pods()
    pdbs = Limits.from_pdbs(store.list("PodDisruptionBudget"))
    for c in candidates:
        pods.extend(
            p for p in c.reschedulable_pods if pdbs.is_currently_reschedulable(p)
        )
    deleting_node_pods = [
        p
        for n in deleting_nodes
        for p in n.currently_reschedulable_pods(store, pdbs)
    ]
    pods.extend(deleting_node_pods)
    deleting_pod_keys = {
        (p.metadata.namespace, p.metadata.name) for p in deleting_node_pods
    }

    # simulations are silent (the reference's NopLogger injection,
    # helpers.go:102,115): consolidation runs hundreds per pass. Routing
    # through the provisioner's solverd client lets simulations coalesce
    # into the same device batches as provisioning solves.
    from karpenter_tpu_torch.solverd import KIND_SIMULATE

    with klog.nop():
        scheduler = provisioner.new_scheduler(pods, state_nodes)
        results = provisioner.solver.solve(
            KIND_SIMULATE, scheduler, pods, timeout=60.0
        )
    results.truncate_instance_types()
    # Pods landing on uninitialized nodes are speculative — fail them so
    # consolidation doesn't rely on capacity that may never materialize.
    for en in results.existing_nodes:
        if not en.initialized():
            for p in en.pods:
                if (p.metadata.namespace, p.metadata.name) not in deleting_pod_keys:
                    results.pod_errors[p] = UninitializedNodeError(
                        f"would schedule against uninitialized node {en.name()}"
                    )
    return results


class FrontierSimulator:
    """Shared context for one consolidation pass's batched simulations.

    The sequential `simulate_scheduling` rebuilds the world per probe: a
    deep-copied node snapshot, pending-pod discovery, PDB limits, and a
    from-scratch Scheduler — ~90% of a probe's cost at 1k nodes, all of it
    identical across the probes of one `compute_command`. This hoists that
    work out once: ONE uncopied cluster view (safe since ExistingNode went
    copy-on-write — simulations never write through StateNodes), one PDB/
    pending/catalog/daemonset gather, and per-node ExistingNode prototypes
    (existingnode.build_node_prototypes) that per-probe schedulers stamp
    instead of re-derive. `solve_batch` then runs a whole frontier round of
    probe simulations as one frontier-tagged solverd group, coalesced into
    a single device batch.

    Lifetime: one compute_command. The shared view relies on the cluster
    not changing between probes, which the single-threaded operator loop
    guarantees within a pass."""

    _tags = itertools.count(1)

    def __init__(self, store: Store, cluster: Cluster, provisioner: "Provisioner"):
        from karpenter_tpu_torch.scheduler.existingnode import build_node_prototypes
        from karpenter_tpu_torch.utils import nodepool as nputil

        self.store = store
        self.cluster = cluster
        self.provisioner = provisioner
        nodes = cluster.state_nodes_view()
        self._deleting_nodes = deleting(nodes)
        self._deleting_names = {n.name() for n in self._deleting_nodes}
        self._active_nodes = active(nodes)
        self.pdbs = Limits.from_pdbs(store.list("PodDisruptionBudget"))
        self._base_pending = provisioner.get_pending_pods()
        self._deleting_node_pods = [
            p
            for n in self._deleting_nodes
            for p in n.currently_reschedulable_pods(store, self.pdbs)
        ]
        self._deleting_pod_keys = {
            (p.metadata.namespace, p.metadata.name)
            for p in self._deleting_node_pods
        }
        # the provisioning context new_scheduler re-derives per probe,
        # gathered once (provisioner.go:220-279)
        self._node_pools = nputil.order_by_weight(
            nputil.list_managed(store, ready_only=True)
        )
        self._instance_types = (
            provisioner._gather_instance_types(self._node_pools)
            if self._node_pools
            else {}
        )
        self._daemonset_pods = provisioner.get_daemonset_pods()
        self._engine = (
            provisioner.engine_factory(self._instance_types)
            if provisioner.engine_factory and self._node_pools
            else None
        )
        if self._engine is not None:
            provisioner._alert_native_fallback()
        # prototype cache lives on the provisioner so it spans passes; the
        # build validates every entry against live node identity + usage_seq
        if not hasattr(provisioner, "_node_prototype_cache"):
            provisioner._node_prototype_cache = {}
        self._prototypes = build_node_prototypes(
            self._active_nodes,
            self._daemonset_pods,
            cache=provisioner._node_prototype_cache,
        )
        # per-plan fast paths: node names paired once (name() is an
        # attribute chase x 1k nodes x k probes otherwise), and each
        # candidate's PDB-filtered reschedulable pods computed once — the
        # pdbs are fixed for the pass and prefixes reuse candidates
        self._named_nodes = [(n.name(), n) for n in self._active_nodes]
        self._resched_cache: dict[int, list[Pod]] = {}

    def plan(self, candidates: Sequence[Candidate]) -> "SimulationPlan":
        """Build one probe's scheduler + pod queue against the shared view
        (the prepare half of `simulate_scheduling`). A prefix containing a
        deleting candidate yields a plan carrying CandidateDeletingError,
        exactly where the sequential path raises it."""
        from karpenter_tpu_torch.controllers.provisioning.provisioner import (
            NoNodePoolsError,
        )
        from karpenter_tpu_torch.scheduler.scheduler import Scheduler
        from karpenter_tpu_torch.scheduler.topology import Topology

        plan = SimulationPlan()
        candidate_names = {c.name() for c in candidates}
        if candidate_names & self._deleting_names:
            plan.error = CandidateDeletingError()
            return plan
        if not self._node_pools:
            plan.error = NoNodePoolsError("no nodepools found")
            return plan
        state_nodes = [
            n for name, n in self._named_nodes if name not in candidate_names
        ]
        pods = list(self._base_pending)
        for c in candidates:
            cached = self._resched_cache.get(id(c))
            if cached is None:
                cached = [
                    p
                    for p in c.reschedulable_pods
                    if self.pdbs.is_currently_reschedulable(p)
                ]
                self._resched_cache[id(c)] = cached
            pods.extend(cached)
        pods.extend(self._deleting_node_pods)
        for pod in pods:
            self.provisioner.volume_topology.inject(pod)
        topology = Topology(
            self.store,
            self.cluster,
            state_nodes,
            self._node_pools,
            self._instance_types,
            pods,
            preference_policy=self.provisioner.options.preferences_policy,
        )
        plan.scheduler = Scheduler(
            self.store,
            self._node_pools,
            self.cluster,
            state_nodes,
            topology,
            self._instance_types,
            self._daemonset_pods,
            self.provisioner.recorder,
            self.provisioner.clock,
            preference_policy=self.provisioner.options.preferences_policy,
            min_values_policy=self.provisioner.options.min_values_policy,
            reserved_offering_mode="Strict",
            reserved_capacity_enabled=(
                self.provisioner.options.feature_gates.reserved_capacity
            ),
            engine=self._engine,
            node_prototypes=self._prototypes,
        )
        plan.pods = pods
        return plan

    def solve_batch(
        self, plans: Sequence["SimulationPlan"], nested: bool = True
    ) -> None:
        """Run every viable plan's simulation as ONE frontier-tagged solverd
        group (one coalesced device batch), filling plan.results /
        plan.error. Per-plan solver errors stay on their plan: the frontier
        walk only surfaces the failures the sequential search would have
        hit. `nested` declares the plans' pod sets nest (multi-node prefix
        rounds) so the coalescer may prime from the largest member alone;
        single-node rounds pass False — their probes are disjoint."""
        from karpenter_tpu_torch.device import KernelError
        from karpenter_tpu_torch.solverd import KIND_SIMULATE

        live = [p for p in plans if p.error is None]
        if not live:
            return
        tag = f"frontier-{next(self._tags)}"
        with klog.nop():
            outcomes = self.provisioner.solver.solve_many(
                KIND_SIMULATE,
                [(p.scheduler, p.pods) for p in live],
                timeout=60.0,
                group=tag,
                nested=nested,
            )
        # port: a device fault on any probe of the round, walked or
        # speculative, fails the compute here, before the walk — the
        # sequential semantics above cover solver errors, not a card that
        # gave a wrong or no answer
        fault = next((e for _, e in outcomes if isinstance(e, KernelError)), None)
        if fault is not None:
            raise fault
        for plan, (results, error) in zip(live, outcomes):
            if error is not None:
                plan.error = error
                continue
            results.truncate_instance_types()
            for en in results.existing_nodes:
                if not en.initialized():
                    for p in en.pods:
                        key = (p.metadata.namespace, p.metadata.name)
                        if key not in self._deleting_pod_keys:
                            results.pod_errors[p] = UninitializedNodeError(
                                f"would schedule against uninitialized node "
                                f"{en.name()}"
                            )
            plan.results = results


class SimulationPlan:
    """One probe's prepared simulation: scheduler + pods going in,
    results or a typed error coming out."""

    __slots__ = ("scheduler", "pods", "results", "error")

    def __init__(self):
        self.scheduler = None
        self.pods: list[Pod] = []
        self.results: Optional[Results] = None
        self.error: Optional[Exception] = None


def instance_types_are_subset(
    lhs: list[InstanceType], rhs: list[InstanceType]
) -> bool:
    rhs_names = {it.name for it in rhs}
    return all(it.name in rhs_names for it in lhs)


def build_nodepool_map(
    store: Store, cloud_provider: CloudProvider
) -> tuple[dict[str, NodePool], dict[str, dict[str, InstanceType]]]:
    """helpers.go:191-222."""
    nodepool_map: dict[str, NodePool] = {}
    nodepool_its: dict[str, dict[str, InstanceType]] = {}
    for np in nodepoolutil.list_managed(store):
        nodepool_map[np.metadata.name] = np
        its = cloud_provider.get_instance_types(np)
        if its:
            nodepool_its[np.metadata.name] = {it.name: it for it in its}
    return nodepool_map, nodepool_its


def get_candidates(
    store: Store,
    cluster: Cluster,
    recorder: Recorder,
    clock: Clock,
    cloud_provider: CloudProvider,
    should_disrupt: Callable[[Candidate], bool],
    disruption_class: str,
    queue,
    pass_cache: Optional[dict] = None,
    node_prefilter: Optional[Callable[[StateNode], bool]] = None,
) -> list[Candidate]:
    """helpers.go:164-189.

    Candidates are built over the live node VIEW, not deep copies: every
    candidate consumer is a reader (simulations fork usage copy-on-write,
    commands act through the store by name), and the copies were ~30% of a
    1k-candidate consolidation pass. A parked command's candidates may see
    informer updates land before validation — validation re-fetches fresh
    candidates anyway, so staleness was never load-bearing.

    `pass_cache` (a dict scoped to ONE reconcile pass) shares the
    method-independent construction — node validation, PDB walks, cost
    model — across the methods of a pass, keyed by disruption class (the
    one input new_candidate branches on). Queue and store state are stable
    within a pass, so the shared bases are exact; only `should_disrupt`
    runs per method. Duplicate DisruptionBlocked events the repeat builds
    would have published were already dropped by the recorder's dedupe.

    `node_prefilter` skips candidate construction for nodes the method
    can already rule out from the StateNode alone (drift checks one claim
    condition); it must be a pure superset of the method's should_disrupt
    so the final candidate set is unchanged. Prefiltered results never
    enter the pass cache — they are method-specific by construction."""
    if node_prefilter is not None:
        pass_cache = None
    bases = pass_cache.get(disruption_class) if pass_cache is not None else None
    if bases is None:
        nodepool_map, nodepool_its = build_nodepool_map(store, cloud_provider)
        pdbs = Limits.from_pdbs(store.list("PodDisruptionBudget"))
        bases = []
        for node in cluster.state_nodes_view():
            if node_prefilter is not None and not node_prefilter(node):
                continue
            try:
                bases.append(
                    new_candidate(
                        store, recorder, clock, node, pdbs, nodepool_map,
                        nodepool_its, queue, disruption_class,
                    )
                )
            except Exception:  # noqa: BLE001 — non-candidates are expected
                continue
        if pass_cache is not None:
            pass_cache[disruption_class] = bases
    return [c for c in bases if should_disrupt(c)]


def build_disruption_budget_mapping(
    store: Store,
    cluster: Cluster,
    clock: Clock,
    recorder: Recorder,
    reason: str,
) -> dict[str, int]:
    """nodepool -> remaining allowed disruptions now (helpers.go:225-273)."""
    from karpenter_tpu_torch.apis.nodeclaim import CONDITION_INSTANCE_TERMINATING

    num_nodes: dict[str, int] = {}
    disrupting: dict[str, int] = {}
    for node in cluster.state_nodes_view():
        if not node.managed() or not node.initialized():
            continue
        if node.node_claim.condition_is_true(CONDITION_INSTANCE_TERMINATING):
            continue
        pool = node.labels().get(wk.NODEPOOL_LABEL_KEY, "")
        num_nodes[pool] = num_nodes.get(pool, 0) + 1
        ready = True
        if node.node is not None:
            cond = next(
                (c for c in node.node.status.conditions if c.type == "Ready"), None
            )
            ready = cond is None or cond.status == "True"
        if not ready or node.is_marked_for_deletion():
            disrupting[pool] = disrupting.get(pool, 0) + 1
    mapping: dict[str, int] = {}
    for np in nodepoolutil.list_managed(store):
        name = np.metadata.name
        allowed = np.allowed_disruptions(reason, num_nodes.get(name, 0), clock.now())
        mapping[name] = max(allowed - disrupting.get(name, 0), 0)
        _ALLOWED_DISRUPTIONS.set(
            float(allowed), {"nodepool": name, "reason": reason}
        )
        if num_nodes.get(name, 0) != 0 and allowed == 0:
            recorder.publish(
                Event(
                    np,
                    "Normal",
                    "DisruptionBlocked",
                    f"No allowed disruptions for disruption reason {reason}",
                )
            )
    return mapping


def map_candidates(proposed: list[Candidate], current: list[Candidate]) -> list[Candidate]:
    names = {c.name() for c in proposed}
    return [c for c in current if c.name() in names]
