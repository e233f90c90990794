"""Scheduler: the first-fit-decreasing provisioning solver.

Mirrors the reference's scheduling/scheduler.go:95-699. The outer FFD loop
(Pop → trySchedule → relax/Push) is inherently sequential — each placement
mutates node state — so it stays host-side; the per-pod candidate scans that
the reference fans out over goroutines with earliest-index-wins
(scheduler.go:677-699) are here sequential scans whose hot inner kernel
(`filter_instance_types`) dispatches to the batched device engine
(SURVEY.md §2 "TPU-native equivalent"). Earliest-index-wins is preserved
exactly: we take the first feasible candidate in order.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional, Sequence

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.apis.nodepool import NodePool
from karpenter_tpu_torch.apis.core import pod_resource_requests
from karpenter_tpu_torch.events.recorder import Event, Recorder
from karpenter_tpu_torch.metrics import global_registry, measure
from karpenter_tpu_torch.cloudprovider.types import InstanceType
from karpenter_tpu_torch.device import KernelError
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.scheduler.existingnode import ExistingNode
from karpenter_tpu_torch.scheduler.nodeclaim import (
    NodeClaim,
    RESERVED_OFFERING_MODE_FALLBACK,
    ReservedOfferingError,
    filter_instance_types,
)
from karpenter_tpu_torch.scheduler.nodeclaimtemplate import MAX_INSTANCE_TYPES, NodeClaimTemplate
from karpenter_tpu_torch.scheduler.preferences import Preferences
from karpenter_tpu_torch.scheduler.queue import Queue
from karpenter_tpu_torch.scheduler.topology import (
    PREFERENCE_POLICY_IGNORE,
    PREFERENCE_POLICY_RESPECT,
    Topology,
)
from karpenter_tpu_torch.scheduling.hostportusage import HostPortUsage, get_host_ports
from karpenter_tpu_torch.scheduling.requirements import (
    ALLOW_UNDEFINED_WELL_KNOWN_LABELS,
    Requirements,
    has_preferred_node_affinity,
    pod_requirements,
    strict_pod_requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taints
from karpenter_tpu_torch.scheduling.volumeusage import get_volumes
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.resources import ResourceList

MIN_VALUES_POLICY_STRICT = "Strict"
MIN_VALUES_POLICY_BEST_EFFORT = "BestEffort"

_DURATION_HIST = global_registry.histogram(
    "karpenter_scheduler_scheduling_duration_seconds",
    "duration of scheduling simulations",
)
_UNSCHEDULABLE_GAUGE = global_registry.gauge(
    "karpenter_scheduler_unschedulable_pods_count", "pods that failed to schedule"
)
# live-solve introspection series (scheduling/metrics.go:47-72): the
# reference updates them from a 1s ticker goroutine while Solve runs and
# deletes them at the end; the host loop here refreshes on the same 1s
# cadence from its injected clock, and both series vanish when the solve
# finishes so no stale per-solve series outlive it
_QUEUE_DEPTH = global_registry.gauge(
    "karpenter_scheduler_queue_depth",
    "pods currently waiting to be scheduled",
    labels=["scheduling_id"],
)
_UNFINISHED_WORK = global_registry.gauge(
    "karpenter_scheduler_unfinished_work_seconds",
    "in-progress solve time not yet observed by scheduling_duration_seconds",
    labels=["scheduling_id"],
)


@dataclass
class PodData:
    requests: ResourceList
    requirements: Requirements
    strict_requirements: Requirements


@dataclass
class Results:
    """Solver output (scheduler.go:195-258)."""

    new_node_claims: list[NodeClaim]
    existing_nodes: list[ExistingNode]
    pod_errors: dict[Pod, Exception]
    # The solve hit its timeout: unprocessed pods get a pod_errors entry and
    # all_non_pending_pods_scheduled() returns False, so consolidation/drift
    # simulations can't treat a truncated solve as fully scheduled (the
    # reference surfaces ctx.Err() to callers).
    timed_out: bool = False

    def record(self, recorder: Recorder, cluster: Cluster) -> None:
        from karpenter_tpu_torch.observability import explain as explmod

        ledger = explmod.recorder()
        for p, err in self.pod_errors.items():
            if isinstance(err, ReservedOfferingError):
                continue
            message = f"Failed to schedule pod, {err}"
            if ledger.enabled:
                # provenance enrichment (--explain): the top eliminating
                # stages replace squinting at the aggregated tuple string;
                # gated on mode so default event streams stay byte-identical
                reasons = ledger.top_reasons(p.metadata.uid, k=3)
                if reasons:
                    message += f" (top eliminations: {', '.join(reasons)})"
            recorder.publish(
                Event(p, "Warning", "FailedScheduling", message)
            )
        for existing in self.existing_nodes:
            if existing.pods:
                cluster.nominate_node_for_pod(existing.provider_id())
            for p in existing.pods:
                recorder.publish(
                    Event(p, "Normal", "Nominated", f"Pod should schedule on {existing.name()}")
                )

    def reserved_offering_errors(self) -> dict:
        return {
            p: e for p, e in self.pod_errors.items() if isinstance(e, ReservedOfferingError)
        }

    def nodepool_to_pod_mapping(self) -> dict[str, list[Pod]]:
        out: dict[str, list[Pod]] = {}
        for nc in self.new_node_claims:
            out.setdefault(nc.labels.get(wk.NODEPOOL_LABEL_KEY, ""), []).extend(nc.pods)
        for en in self.existing_nodes:
            out.setdefault(en.labels().get(wk.NODEPOOL_LABEL_KEY, ""), []).extend(en.pods)
        return out

    def existing_node_to_pod_mapping(self) -> dict[str, list[Pod]]:
        return {
            en.node_claim.metadata.name: en.pods
            for en in self.existing_nodes
            if en.managed() and en.pods
        }

    def all_non_pending_pods_scheduled(self) -> bool:
        if self.timed_out:
            return False
        return not [
            p for p in self.pod_errors if not podutil.is_provisionable(p)
        ]

    def non_pending_pod_scheduling_errors(self) -> str:
        errs = {p: e for p, e in self.pod_errors.items() if not podutil.is_provisionable(p)}
        if not errs:
            return ""
        parts = [
            f"{p.metadata.namespace}/{p.metadata.name} => {e}"
            for p, e in list(errs.items())[:5]
        ]
        suffix = f" and {len(errs) - 5} other(s)" if len(errs) > 5 else ""
        return "not all pods would schedule, " + "; ".join(parts) + suffix

    def truncate_instance_types(self, max_items: int = MAX_INSTANCE_TYPES) -> "Results":
        """Truncate each new claim's options, honoring minValues
        (scheduler.go:320-339)."""
        from karpenter_tpu_torch.cloudprovider.types import truncate_instance_types

        valid = []
        for nc in self.new_node_claims:
            truncated, err = truncate_instance_types(
                nc.instance_type_options, nc.requirements, max_items
            )
            if err is not None:
                for p in nc.pods:
                    self.pod_errors[p] = ValueError(
                        f"pod didn't schedule because NodePool {nc.nodepool_name} "
                        f"couldn't meet minValues requirements, {err}"
                    )
            else:
                nc.instance_type_options = truncated
                valid.append(nc)
        self.new_node_claims = valid
        return self


class Scheduler:
    def __init__(
        self,
        store: Store,
        node_pools: Sequence[NodePool],
        cluster: Cluster,
        state_nodes: Sequence[StateNode],
        topology: Topology,
        instance_types: dict[str, list[InstanceType]],
        daemonset_pods: Sequence[Pod],
        recorder: Recorder,
        clock: Clock,
        preference_policy: str = PREFERENCE_POLICY_RESPECT,
        min_values_policy: str = MIN_VALUES_POLICY_STRICT,
        reserved_offering_mode: str = RESERVED_OFFERING_MODE_FALLBACK,
        reserved_capacity_enabled: bool = True,
        engine=None,
        node_prototypes=None,
    ):
        self.store = store
        self.cluster = cluster
        self.topology = topology
        self.recorder = recorder
        self.clock = clock
        # shared per-node statics for repeated scheduler builds over one
        # cluster view (consolidation frontier probes); see
        # existingnode.build_node_prototypes
        self.node_prototypes = node_prototypes
        self.preference_policy = preference_policy
        self.min_values_policy = min_values_policy
        self.reserved_offering_mode = reserved_offering_mode
        self.reserved_capacity_enabled = reserved_capacity_enabled
        self.engine = engine

        # Weighted order decides which pool hosts a pod when several can
        # (reference sorts via nodepoolutils.OrderByWeight, provisioner.go:244).
        from karpenter_tpu_torch.utils.nodepool import order_by_weight

        node_pools = order_by_weight(node_pools)
        tolerate_prefer_no_schedule = any(
            t.effect == "PreferNoSchedule"
            for np in node_pools
            for t in np.spec.template.spec.taints
        )
        self.preferences = Preferences(tolerate_prefer_no_schedule)

        # Templates whose requirements admit at least one instance type
        # (scheduler.go:118-135).
        self.nodeclaim_templates: list[NodeClaimTemplate] = []
        for np in node_pools:
            nct = NodeClaimTemplate(np)
            options, _, err = filter_instance_types(
                instance_types.get(np.metadata.name, []),
                nct.requirements,
                {},
                relax_min_values=min_values_policy == MIN_VALUES_POLICY_BEST_EFFORT,
                engine=engine,
            )
            nct.instance_type_options = options
            if not options:
                self.recorder.publish(
                    Event(
                        np,
                        "Warning",
                        "NoCompatibleInstanceTypes",
                        "NodePool requirements filtered out all compatible available "
                        "instance types",
                    )
                )
                continue
            self.nodeclaim_templates.append(nct)

        self.remaining_resources: dict[str, ResourceList] = {
            np.metadata.name: dict(np.spec.limits) for np in node_pools
        }
        self.daemon_overhead: dict[NodeClaimTemplate, ResourceList] = {}
        self.daemon_hostports: dict[NodeClaimTemplate, HostPortUsage] = {}
        for nct in self.nodeclaim_templates:
            compatible = [p for p in daemonset_pods if _is_daemon_pod_compatible(nct, p)]
            self.daemon_overhead[nct] = res.merge(
                *(pod_resource_requests(p) for p in compatible)
            )
            usage = HostPortUsage()
            for p in compatible:
                usage.add(p, get_host_ports(p))
            self.daemon_hostports[nct] = usage

        from karpenter_tpu_torch.scheduler.reservationmanager import ReservationManager

        self.reservation_manager = ReservationManager(instance_types)
        self.new_node_claims: list[NodeClaim] = []
        self.existing_nodes: list[ExistingNode] = []
        self.cached_pod_data: dict[str, PodData] = {}
        self._calculate_existing_nodes(state_nodes, daemonset_pods)

    # -- setup --------------------------------------------------------------

    def _calculate_existing_nodes(
        self, state_nodes: Sequence[StateNode], daemonset_pods: Sequence[Pod]
    ) -> None:
        """Existing nodes participate with their unaccounted daemon overhead;
        their capacity counts against nodepool limits (scheduler.go:559-587).

        With `node_prototypes` (the consolidation frontier's shared statics,
        existingnode.build_node_prototypes), nodes stamp from their
        prototype instead of re-deriving taints/requirements/daemon headroom
        — identity-checked against the StateNode so a stale prototype map
        can only ever fall back to the full path, never serve wrong data."""
        for node in state_nodes:
            proto = (
                self.node_prototypes.get(node.name())
                if self.node_prototypes
                else None
            )
            if proto is not None and proto.state_node is node:
                self.existing_nodes.append(
                    ExistingNode.from_prototype(proto, self.topology)
                )
                pool_name = proto.pool_name
                capacity = proto.capacity
            else:
                taints = node.taints()
                daemons = []
                if daemonset_pods:
                    node_taints = Taints(taints)
                    node_reqs = Requirements.from_labels(node.labels())
                    for p in daemonset_pods:
                        if node_taints.tolerates_pod(p) is not None:
                            continue
                        if not node_reqs.is_compatible(strict_pod_requirements(p)):
                            continue
                        daemons.append(p)
                self.existing_nodes.append(
                    ExistingNode(
                        node,
                        self.topology,
                        taints,
                        res.merge(*(pod_resource_requests(p) for p in daemons)),
                    )
                )
                pool_name = node.labels().get(wk.NODEPOOL_LABEL_KEY, "")
                capacity = node.capacity()
            # subtract() keeps LHS keys only, so a pool with no limits ({})
            # is a fixed point — skip the per-node call for it
            if self.remaining_resources.get(pool_name):
                self.remaining_resources[pool_name] = res.subtract(
                    self.remaining_resources[pool_name], capacity
                )
        self.existing_nodes.sort(key=ExistingNode.sort_key)

    def update_cached_pod_data(self, p: Pod) -> None:
        if self.preference_policy == PREFERENCE_POLICY_IGNORE:
            requirements = strict_pod_requirements(p)
        else:
            requirements = pod_requirements(p)
        strict = requirements
        if has_preferred_node_affinity(p):
            strict = strict_pod_requirements(p)
        self.cached_pod_data[p.metadata.uid] = PodData(
            requests=pod_resource_requests(p),
            requirements=requirements,
            strict_requirements=strict,
        )

    # -- solve (scheduler.go:346-429) ---------------------------------------

    def solve(self, pods: Sequence[Pod], timeout: Optional[float] = 60.0) -> Results:
        import uuid as _uuid

        sid = {"scheduling_id": _uuid.uuid4().hex[:8]}
        try:
            with measure(_DURATION_HIST):
                return self._solve(list(pods), timeout, sid)
        finally:
            # per-solve series never outlive the solve (scheduler.go:391)
            _QUEUE_DEPTH.delete(sid)
            _UNFINISHED_WORK.delete(sid)

    def _solve(self, pods: list[Pod], timeout: Optional[float], sid: dict) -> Results:
        pod_errors: dict[Pod, Exception] = {}
        _QUEUE_DEPTH.set(float(len(pods)), sid)
        _UNFINISHED_WORK.set(0.0, sid)
        # Device fast path: grouped FFD with the feasibility cube on the TPU
        # (ops/ffd.py). It computes pod data once per distinct pod shape.
        # Returns None when ineligible or when its final verification can't
        # guarantee host-identical semantics — then the host per-pod loop
        # below remains the oracle.
        if self.engine is not None:
            from karpenter_tpu_torch.ops import ffd

            device_results = ffd.solve_device(self, pods, timeout)
            if device_results is not None:
                _UNSCHEDULABLE_GAUGE.set(float(len(device_results.pod_errors)))
                return device_results
        for p in pods:
            self.update_cached_pod_data(p)
        q = Queue(pods, self.cached_pod_data)
        start = self.clock.now()
        last_tick = start
        timed_out = False
        while True:
            pod = q.pop()
            if pod is None:
                break
            now = self.clock.now()
            if now - last_tick >= 1.0:  # the reference's 1s ticker cadence
                last_tick = now
                _QUEUE_DEPTH.set(float(len(q)), sid)
                _UNFINISHED_WORK.set(now - start, sid)
            if timeout is not None and self.clock.now() - start > timeout:
                # Surface the truncation: the popped pod and everything left
                # in the queue were never attempted this round.
                timed_out = True
                pod_errors.setdefault(
                    pod, TimeoutError("scheduling simulation timed out")
                )
                while True:
                    rest = q.pop()
                    if rest is None:
                        break
                    pod_errors.setdefault(
                        rest, TimeoutError("scheduling simulation timed out")
                    )
                break
            try:
                self._try_schedule(copy.deepcopy(pod))
                pod_errors.pop(pod, None)
            except KernelError:
                # a device fault is not a pod's error: it fails the solve
                raise
            except Exception as err:  # noqa: BLE001 — per-pod failures collect
                pod_errors[pod] = err
                self.topology.update(pod)
                self.update_cached_pod_data(pod)
                q.push(pod)
        for nc in self.new_node_claims:
            nc.finalize_scheduling()
        _UNSCHEDULABLE_GAUGE.set(float(len(pod_errors)))
        return Results(
            new_node_claims=self.new_node_claims,
            existing_nodes=self.existing_nodes,
            pod_errors=pod_errors,
            timed_out=timed_out,
        )

    def _try_schedule(self, p: Pod) -> None:
        """Add, relaxing one preference at a time on failure
        (scheduler.go:351-371). Mutations to the relaxed pod copy persist via
        the cached pod data keyed by UID."""
        while True:
            try:
                self._add(p)
                return
            except (ReservedOfferingError, KernelError):
                raise
            except Exception:
                if not self.preferences.relax(p):
                    raise
                self.topology.update(p)
                self.update_cached_pod_data(p)

    def _add(self, pod: Pod) -> None:
        # 1. existing nodes, first feasible in sorted order
        try:
            self._add_to_existing_node(pod)
            return
        except ReservedOfferingError:
            raise
        except Exception:
            pass
        # 2. in-flight claims, emptiest-first so pods pack tightly
        # (scheduler.go:457-459)
        self.new_node_claims.sort(key=lambda n: len(n.pods))
        try:
            self._add_to_inflight_node(pod)
            return
        except (ReservedOfferingError, KernelError):
            raise
        except Exception:
            pass
        if not self.nodeclaim_templates:
            raise ValueError("nodepool requirements filtered out all available instance types")
        self._add_to_new_node_claim(pod)

    def _add_to_existing_node(self, pod: Pod) -> None:
        volumes = get_volumes(self.store, pod)
        pod_data = self.cached_pod_data[pod.metadata.uid]
        for node in self.existing_nodes:
            try:
                requirements = node.can_add(pod, pod_data, volumes)
            except Exception:  # noqa: BLE001 — per-node misses are expected
                continue
            node.add(pod, pod_data, requirements, volumes)
            return
        raise ValueError("failed scheduling pod to existing nodes")

    def _add_to_inflight_node(self, pod: Pod) -> None:
        pod_data = self.cached_pod_data[pod.metadata.uid]
        for nc in self.new_node_claims:
            try:
                requirements, its, offerings = nc.can_add(pod, pod_data, False)
            except KernelError:
                raise
            except Exception:  # noqa: BLE001
                continue
            nc.add(pod, pod_data, requirements, its, offerings)
            return
        raise ValueError("failed scheduling pod to inflight nodes")

    def _add_to_new_node_claim(self, pod: Pod) -> None:
        """Weighted-template order, first feasible wins; reserved-offering
        errors propagate (scheduler.go:478-556)."""
        pod_data = self.cached_pod_data[pod.metadata.uid]
        errs = []
        # parallel nodepool attribution for the provenance funnel
        # (observability/explain.py); the raised error is unchanged
        pools: list[str] = []
        reserved_err: Optional[ReservedOfferingError] = None
        for nct in self.nodeclaim_templates:
            its = nct.instance_type_options
            remaining = self.remaining_resources.get(nct.nodepool_name)
            if remaining is not None and remaining:
                its = _filter_by_remaining_resources(its, remaining)
                if not its:
                    errs.append(
                        ValueError(
                            f"all available instance types exceed limits for "
                            f"nodepool {nct.nodepool_name!r}"
                        )
                    )
                    pools.append(nct.nodepool_name)
                    continue
            nc = NodeClaim(
                nct,
                self.topology,
                self.daemon_overhead[nct],
                copy.deepcopy(self.daemon_hostports[nct]),
                its,
                self.reservation_manager,
                self.reserved_offering_mode,
                self.reserved_capacity_enabled,
                engine=self.engine,
            )
            try:
                requirements, its, offerings = nc.can_add(
                    pod, pod_data, self.min_values_policy == MIN_VALUES_POLICY_BEST_EFFORT
                )
            except ReservedOfferingError as e:
                if reserved_err is None:
                    reserved_err = e
                break  # earliest-index-wins: later templates can't override
            except KernelError:
                raise
            except Exception as e:  # noqa: BLE001
                errs.append(e)
                pools.append(nct.nodepool_name)
                continue
            min_values_relaxed = any(
                orig.min_values is not None
                and requirements.get(k).min_values is not None
                and requirements.get(k).min_values < orig.min_values
                for k in nc.requirements.keys()
                for orig in [nc.requirements.get(k)]
            )
            nc.annotations[wk.NODECLAIM_MIN_VALUES_RELAXED_ANNOTATION_KEY] = (
                "true" if min_values_relaxed else "false"
            )
            nc.add(pod, pod_data, requirements, its, offerings)
            self.new_node_claims.append(nc)
            self.remaining_resources[nc.nodepool_name] = _subtract_max(
                self.remaining_resources.get(nc.nodepool_name, {}),
                nc.instance_type_options,
            )
            return
        if reserved_err is not None:
            raise reserved_err
        from karpenter_tpu_torch.observability import explain as explmod

        rec = explmod.recorder()
        if rec.enabled and errs:
            # stage the per-nodepool funnel; the solve-completion barrier
            # (solverd coalescer) commits it only if the pod stays failed
            rec.note_funnel(
                pod.metadata.uid, explmod.funnel_from(list(zip(pools, errs)))
            )
        raise errs[0] if len(errs) == 1 else ValueError(
            "; ".join(str(e) for e in errs) or "no nodepool can host the pod"
        )


def _is_daemon_pod_compatible(nct: NodeClaimTemplate, pod: Pod) -> bool:
    """Does this daemonset pod land on nodes from the template
    (scheduler.go:634-647)? The daemon's preferred terms are ignored and
    required OR-terms relaxed one at a time."""
    preferences = Preferences()
    pod = copy.deepcopy(pod)
    preferences.tolerate_prefer_no_schedule_taints(pod)
    if Taints(nct.spec.taints).tolerates_pod(pod) is not None:
        return False
    while True:
        if nct.requirements.is_compatible(
            strict_pod_requirements(pod), ALLOW_UNDEFINED_WELL_KNOWN_LABELS
        ):
            return True
        if preferences.remove_required_node_affinity_term(pod) is None:
            return False


def _subtract_max(
    remaining: ResourceList, instance_types: Sequence[InstanceType]
) -> ResourceList:
    """Pessimistic limit tracking: assume the largest possible instance type
    launches (scheduler.go:649-668)."""
    if not instance_types:
        return remaining
    it_max = res.max_resources(*(it.capacity for it in instance_types))
    return {k: v - it_max.get(k, 0.0) for k, v in remaining.items()}


def _filter_by_remaining_resources(
    instance_types: Sequence[InstanceType], remaining: ResourceList
) -> list[InstanceType]:
    """Types that fit inside the nodepool's remaining limits
    (scheduler.go:670-686)."""
    out = []
    for it in instance_types:
        if all(it.capacity.get(k, 0.0) <= v + 1e-9 for k, v in remaining.items()):
            out.append(it)
    return out
