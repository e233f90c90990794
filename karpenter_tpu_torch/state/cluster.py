"""Cluster: the in-memory mirror every solver reads.

Mirrors the reference's pkg/controllers/state/cluster.go:52-874 —
providerID→StateNode, pod bindings, per-nodepool resource accounting, the
Synced() barrier, pod scheduling-decision timestamps, and the consolidation
timestamp. Single-writer by design: the controller loop is single-threaded
(SURVEY.md §2 "TPU-native equivalent" — parallelism lives on-device, not in
host threads), so the reference's RWMutex discipline reduces to plain state.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable, Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import DaemonSet, Node, Pod
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodepool import CONDITION_NODE_REGISTRATION_HEALTHY
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.state.statenode import StateNode
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils import resources as res
from karpenter_tpu_torch.utils.clock import Clock
from karpenter_tpu_torch.utils.resources import ResourceList

if TYPE_CHECKING:
    from karpenter_tpu_torch.cloudprovider.types import CloudProvider

# Pseudo-resource counting nodes in nodepool resource accounting
# (pkg/utils/resources resources.Node).
NODE_RESOURCE = "nodes"

# Consolidation timestamp staleness bound (cluster.go:531-543).
CONSOLIDATION_STATE_TTL = 300.0

_SYNCED_GAUGE = global_registry.gauge(
    "karpenter_cluster_state_synced", "cluster state is synced with the store"
)
_NODE_COUNT_GAUGE = global_registry.gauge(
    "karpenter_cluster_state_node_count", "nodes tracked in cluster state"
)
_UNSYNCED_TIME_GAUGE = global_registry.gauge(
    "karpenter_cluster_state_unsynced_time_seconds",
    "time cluster state has been continuously unsynced (0 when synced)",
)
_DECISION_HIST = global_registry.histogram(
    "karpenter_pods_scheduling_decision_duration_seconds",
    "time from pod ack to first scheduling decision",
)


class Cluster:
    def __init__(self, clock: Clock, store: Store, cloud_provider: "CloudProvider",
                 nomination_window: float = 20.0):
        self.clock = clock
        self.store = store
        self.cloud_provider = cloud_provider
        self.nomination_window = max(10.0, nomination_window)

        self.nodes: dict[str, StateNode] = {}  # provider id -> state node
        self.bindings: dict[tuple[str, str], str] = {}  # pod key -> node name
        self.node_name_to_provider_id: dict[str, str] = {}
        self.node_claim_name_to_provider_id: dict[str, str] = {}
        self.nodepool_resources: dict[str, ResourceList] = {}
        self.daemonset_pods: dict[tuple[str, str], Pod] = {}
        self.anti_affinity_pods: dict[tuple[str, str], Pod] = {}

        self.pod_acks: dict[tuple[str, str], float] = {}
        self.pods_scheduling_attempted: dict[tuple[str, str], float] = {}
        self.pods_schedulable_times: dict[tuple[str, str], float] = {}
        self.pod_healthy_nodepool_scheduled_time: dict[tuple[str, str], float] = {}
        self.pod_to_node_claim: dict[tuple[str, str], str] = {}

        self._consolidation_state = 0.0
        self._has_synced = False
        self._unsynced_since: Optional[float] = None

    # -- sync barrier (cluster.go:113-207) ----------------------------------

    def synced(self) -> bool:
        """True once state covers every NodeClaim and Node in the store and
        every claim has resolved a provider id. Solvers must not run before
        this — they'd double-provision against a partial mirror."""
        if self._has_synced:
            ok = all(pid != "" for pid in self.node_claim_name_to_provider_id.values())
            return self._record_synced(ok)
        claims = {nc.metadata.name for nc in self.store.list("NodeClaim")}
        node_names = {n.metadata.name for n in self.store.list("Node")}
        if any(pid == "" for pid in self.node_claim_name_to_provider_id.values()):
            return self._record_synced(False)
        state_claims = set(self.node_claim_name_to_provider_id)
        state_nodes = set(self.node_name_to_provider_id)
        ok = state_claims >= claims and state_nodes >= node_names
        if ok:
            self._has_synced = True
        return self._record_synced(ok)

    def _record_synced(self, ok: bool) -> bool:
        """Synced gauge + continuously-unsynced stopwatch
        (state/metrics.go:47-62 unsynced_time_seconds)."""
        _SYNCED_GAUGE.set(1.0 if ok else 0.0)
        if ok:
            self._unsynced_since = None
            _UNSYNCED_TIME_GAUGE.set(0.0)
        else:
            if self._unsynced_since is None:
                self._unsynced_since = self.clock.now()
            _UNSYNCED_TIME_GAUGE.set(self.clock.now() - self._unsynced_since)
        return ok

    # -- reads --------------------------------------------------------------

    def state_nodes(self) -> list[StateNode]:
        """Deep copies: callers (solvers) mutate usage on them
        (cluster.go:203-209)."""
        return [n.deep_copy() for n in self.nodes.values()]

    def state_nodes_view(self) -> list[StateNode]:
        """The live StateNode objects, uncopied — for read-only consumers.
        Scheduling solves qualify since ExistingNode went copy-on-write (it
        forks usage onto itself instead of writing through the StateNode),
        which is what lets the consolidation frontier share ONE cluster view
        across k probe simulations instead of deep-copying per probe. The
        caller must not outlive the operator pass it snapshotted in: the
        list is stable only while no informer updates run."""
        return list(self.nodes.values())

    def node_for_pod(self, pod: Pod) -> Optional[StateNode]:
        name = self.bindings.get((pod.metadata.namespace, pod.metadata.name))
        if name is None:
            return None
        return self.nodes.get(self.node_name_to_provider_id.get(name, ""))

    def for_pods_with_anti_affinity(self, fn: Callable[[Pod, Node], bool]) -> None:
        """Iterate bound pods with required anti-affinity (cluster.go:181-198)."""
        for key, pod in list(self.anti_affinity_pods.items()):
            node_name = self.bindings.get(key)
            if node_name is None:
                continue
            state_node = self.nodes.get(self.node_name_to_provider_id.get(node_name, ""))
            if state_node is None or state_node.node is None:
                continue
            if not fn(pod, state_node.node):
                return

    def is_node_nominated(self, provider_id: str) -> bool:
        n = self.nodes.get(provider_id)
        return n is not None and n.nominated(self.clock.now())

    def nominate_node_for_pod(self, provider_id: str) -> None:
        n = self.nodes.get(provider_id)
        if n is not None:
            n.nominate(self.clock.now(), self.nomination_window)

    def node_claim_exists(self, name: str) -> bool:
        return name in self.node_claim_name_to_provider_id

    def nodepool_resources_for(self, nodepool_name: str) -> ResourceList:
        return dict(self.nodepool_resources.get(nodepool_name, {}))

    # -- deletion marks -----------------------------------------------------

    def mark_for_deletion(self, *provider_ids: str) -> None:
        for pid in provider_ids:
            n = self.nodes.get(pid)
            if n is not None:
                old = n.shallow_copy()
                n.marked_for_deletion = True
                self._update_nodepool_resources(old, n)

    def unmark_for_deletion(self, *provider_ids: str) -> None:
        for pid in provider_ids:
            n = self.nodes.get(pid)
            if n is not None:
                old = n.shallow_copy()
                n.marked_for_deletion = False
                self._update_nodepool_resources(old, n)

    # -- node claim ingestion (cluster.go:260-300, 544-566) -----------------

    def update_node_claim(self, node_claim: NodeClaim) -> None:
        pid = node_claim.status.provider_id
        existing_pid = self.node_claim_name_to_provider_id.get(node_claim.metadata.name)
        if pid:
            old = self.nodes.get(pid)
            if existing_pid is not None and existing_pid != pid:
                self._cleanup_node_claim(node_claim.metadata.name)
            n = old.shallow_copy() if old is not None else StateNode()
            n.node_claim = node_claim
            self.nodes[pid] = n
            self._update_nodepool_resources(old, n)
            self._trigger_consolidation_on_change(old, n)
        self.node_claim_name_to_provider_id[node_claim.metadata.name] = pid
        _NODE_COUNT_GAUGE.set(float(len(self.nodes)))

    def delete_node_claim(self, name: str) -> None:
        self._cleanup_node_claim(name)
        _NODE_COUNT_GAUGE.set(float(len(self.nodes)))

    def _cleanup_node_claim(self, name: str) -> None:
        pid = self.node_claim_name_to_provider_id.get(name)
        if pid:
            state_node = self.nodes.get(pid)
            if state_node is not None:
                if state_node.node is None:
                    self._update_nodepool_resources(state_node, None)
                    del self.nodes[pid]
                else:
                    old = state_node.shallow_copy()
                    state_node.node_claim = None
                    self._update_nodepool_resources(old, state_node)
            self.mark_unconsolidated()
        self.node_claim_name_to_provider_id.pop(name, None)

    # -- node ingestion (cluster.go:280-300, 558-583) -----------------------

    def update_node(self, node: Node) -> None:
        managed = bool(node.metadata.labels.get(wk.NODEPOOL_LABEL_KEY))
        initialized = bool(node.metadata.labels.get(wk.NODE_INITIALIZED_LABEL_KEY))
        if node.spec.provider_id == "":
            if managed:
                return
            node.spec.provider_id = node.metadata.name
        # Wait for instance-type label on managed uninitialized nodes so the
        # scheduler never sees a half-labeled node (cluster.go:287-289).
        if managed and not node.metadata.labels.get(wk.LABEL_INSTANCE_TYPE) and not initialized:
            return
        pid = node.spec.provider_id
        existing_pid = self.node_name_to_provider_id.get(node.metadata.name)
        if existing_pid is not None and existing_pid != pid:
            self._cleanup_node(node.metadata.name)
        old = self.nodes.get(pid)
        n = StateNode()
        n.node = node
        if old is not None:
            n.node_claim = old.node_claim
            n.marked_for_deletion = old.marked_for_deletion
            n.nominated_until = old.nominated_until
        self._populate_resource_requests(n)
        self._populate_volume_limits(n)
        self.nodes[pid] = n
        self.node_name_to_provider_id[node.metadata.name] = pid
        self._update_nodepool_resources(old, n)
        self._trigger_consolidation_on_change(old, n)
        _NODE_COUNT_GAUGE.set(float(len(self.nodes)))

    def delete_node(self, name: str) -> None:
        self._cleanup_node(name)
        _NODE_COUNT_GAUGE.set(float(len(self.nodes)))

    def _cleanup_node(self, name: str) -> None:
        pid = self.node_name_to_provider_id.get(name)
        if pid:
            state_node = self.nodes.get(pid)
            if state_node is not None:
                if state_node.node_claim is None:
                    self._update_nodepool_resources(state_node, None)
                    del self.nodes[pid]
                else:
                    old = state_node.shallow_copy()
                    state_node.node = None
                    self._update_nodepool_resources(old, state_node)
            self.node_name_to_provider_id.pop(name, None)
            self.mark_unconsolidated()

    def _populate_resource_requests(self, n: StateNode) -> None:
        node_name = n.node.metadata.name
        for pod in self.store.pods_on_node(node_name):
            if podutil.is_terminal(pod):
                continue
            n.update_for_pod(self.store, pod)
            self._cleanup_old_bindings(pod)
            self.bindings[(pod.metadata.namespace, pod.metadata.name)] = pod.spec.node_name

    def _populate_volume_limits(self, n: StateNode) -> None:
        csi = self.store.try_get("CSINode", n.node.metadata.name)
        if csi is None:
            return
        for driver in csi.drivers:
            if driver.allocatable_count is not None:
                n.volume_usage.add_limit(driver.name, driver.allocatable_count)

    # -- pod ingestion (cluster.go:309-321, 680-720) ------------------------

    def update_pod(self, pod: Pod) -> None:
        if podutil.is_terminal(pod):
            self._update_node_usage_from_pod_completion(
                (pod.metadata.namespace, pod.metadata.name)
            )
        else:
            self._update_node_usage_from_pod(pod)
        self._update_pod_anti_affinities(pod)

    def delete_pod(self, namespace: str, name: str) -> None:
        key = (namespace, name)
        self.anti_affinity_pods.pop(key, None)
        self._update_node_usage_from_pod_completion(key)
        self.clear_pod_scheduling_mappings(key)
        self.mark_unconsolidated()

    def _update_node_usage_from_pod(self, pod: Pod) -> None:
        if pod.spec.node_name == "":
            return
        n = self.nodes.get(self.node_name_to_provider_id.get(pod.spec.node_name, ""))
        if n is None:
            return
        n.update_for_pod(self.store, pod)
        self._cleanup_old_bindings(pod)
        self.bindings[(pod.metadata.namespace, pod.metadata.name)] = pod.spec.node_name

    def _update_node_usage_from_pod_completion(self, key: tuple[str, str]) -> None:
        node_name = self.bindings.pop(key, None)
        if node_name is None:
            return
        n = self.nodes.get(self.node_name_to_provider_id.get(node_name, ""))
        if n is not None:
            n.cleanup_for_pod(*key)

    def _cleanup_old_bindings(self, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        old_node_name = self.bindings.get(key)
        if old_node_name is None or old_node_name == pod.spec.node_name:
            return
        old_node = self.nodes.get(self.node_name_to_provider_id.get(old_node_name, ""))
        if old_node is not None:
            old_node.cleanup_for_pod(*key)
            del self.bindings[key]

    def _update_pod_anti_affinities(self, pod: Pod) -> None:
        key = (pod.metadata.namespace, pod.metadata.name)
        if podutil.has_required_pod_anti_affinity(pod):
            self.anti_affinity_pods[key] = pod
        else:
            self.anti_affinity_pods.pop(key, None)

    # -- daemonsets (cluster.go:545-576) ------------------------------------

    def update_daemonset(self, daemonset: DaemonSet) -> None:
        """Cache the newest live pod of each daemonset as the template for
        daemon-overhead estimation on future nodes."""
        newest: Optional[Pod] = None
        for p in self.store.list("Pod", namespace=daemonset.metadata.namespace):
            if not any(
                ref.kind == "DaemonSet" and ref.name == daemonset.metadata.name
                for ref in p.metadata.owner_references
            ):
                continue
            if newest is None or p.metadata.creation_timestamp > newest.metadata.creation_timestamp:
                newest = p
        if newest is not None:
            self.daemonset_pods[
                (daemonset.metadata.namespace, daemonset.metadata.name)
            ] = newest

    def get_daemonset_pod(self, daemonset: DaemonSet) -> Optional[Pod]:
        return self.daemonset_pods.get(
            (daemonset.metadata.namespace, daemonset.metadata.name)
        )

    def delete_daemonset(self, namespace: str, name: str) -> None:
        self.daemonset_pods.pop((namespace, name), None)

    # -- pod scheduling decisions (cluster.go:331-436) ----------------------

    def ack_pods(self, *pods: Pod) -> None:
        now = self.clock.now()
        for pod in pods:
            self.pod_acks.setdefault((pod.metadata.namespace, pod.metadata.name), now)

    def pod_ack_time(self, key: tuple[str, str]) -> float:
        return self.pod_acks.get(key, 0.0)

    def mark_pod_scheduling_decisions(
        self,
        pod_errors: dict,
        nodepool_pods: dict[str, list[Pod]],
        nodeclaim_pods: dict[str, list[Pod]],
    ) -> None:
        """Record which pods got a placement this round and which failed
        (drives pod_scheduling_decision/unbound latency metrics)."""
        now = self.clock.now()
        for pod in pod_errors:
            key = (pod.metadata.namespace, pod.metadata.name)
            self.pods_schedulable_times.pop(key, None)
            self._mark_attempted(key, now)
            self.pod_healthy_nodepool_scheduled_time.pop(key, None)
            self.pod_to_node_claim.pop(key, None)
        for nodepool_name, pods in nodepool_pods.items():
            nodepool = (
                self.store.try_get("NodePool", nodepool_name) if nodepool_name else None
            )
            healthy = nodepool is not None and nodepool.condition_is_true(
                CONDITION_NODE_REGISTRATION_HEALTHY
            )
            for p in pods:
                key = (p.metadata.namespace, p.metadata.name)
                self.pods_schedulable_times.setdefault(key, now)
                self._mark_attempted(key, now)
                if healthy:
                    self.pod_healthy_nodepool_scheduled_time.setdefault(key, now)
                else:
                    self.pod_healthy_nodepool_scheduled_time.pop(key, None)
        for nc_name, pods in nodeclaim_pods.items():
            for p in pods:
                self.pod_to_node_claim[(p.metadata.namespace, p.metadata.name)] = nc_name

    def _mark_attempted(self, key: tuple[str, str], now: float) -> None:
        if key not in self.pods_scheduling_attempted:
            self.pods_scheduling_attempted[key] = now
            ack = self.pod_ack_time(key)
            if ack:
                _DECISION_HIST.observe(now - ack)

    def pod_scheduling_decision_time(self, key: tuple[str, str]) -> float:
        return self.pods_scheduling_attempted.get(key, 0.0)

    def pod_scheduling_success_time(self, key: tuple[str, str]) -> float:
        return self.pods_schedulable_times.get(key, 0.0)

    def pod_node_claim_mapping(self, key: tuple[str, str]) -> str:
        return self.pod_to_node_claim.get(key, "")

    def clear_pod_scheduling_mappings(self, key: tuple[str, str]) -> None:
        self.pod_acks.pop(key, None)
        self.pods_schedulable_times.pop(key, None)
        self.pods_scheduling_attempted.pop(key, None)
        self.pod_healthy_nodepool_scheduled_time.pop(key, None)
        self.pod_to_node_claim.pop(key, None)

    # -- consolidation timestamp (cluster.go:517-543) -----------------------

    def mark_unconsolidated(self) -> float:
        self._consolidation_state = self.clock.now()
        return self._consolidation_state

    def consolidation_state(self) -> float:
        state = self._consolidation_state
        if self.clock.now() - state < CONSOLIDATION_STATE_TTL:
            return state
        return self.mark_unconsolidated()

    def _trigger_consolidation_on_change(
        self, old: Optional[StateNode], new: StateNode
    ) -> None:
        """New nodes or initialization/deletion-mark flips invalidate prior
        consolidation decisions (cluster.go:857-874)."""
        if old is None or (old.node is None and old.node_claim is None):
            self.mark_unconsolidated()
            return
        if old.initialized() != new.initialized():
            self.mark_unconsolidated()
        if old.is_marked_for_deletion() != new.is_marked_for_deletion():
            self.mark_unconsolidated()

    # -- nodepool resource accounting (cluster.go:600-646) ------------------

    def _update_nodepool_resources(
        self, old: Optional[StateNode], new: Optional[StateNode]
    ) -> None:
        old_name, old_resources = "", {}
        new_name, new_resources = "", {}
        if old is not None and (old.node is not None or old.node_claim is not None):
            old_name = old.labels().get(wk.NODEPOOL_LABEL_KEY, "")
            old_resources = {} if old.is_marked_for_deletion() else old.capacity()
        if new is not None and (new.node is not None or new.node_claim is not None):
            new_name = new.labels().get(wk.NODEPOOL_LABEL_KEY, "")
            new_resources = {} if new.is_marked_for_deletion() else new.capacity()
        if old_resources:
            old_resources = dict(old_resources)
            old_resources[NODE_RESOURCE] = 1.0
        if new_resources:
            new_resources = dict(new_resources)
            new_resources[NODE_RESOURCE] = 1.0
        if old_name:
            self.nodepool_resources[old_name] = res.subtract_into(
                self.nodepool_resources.get(old_name, {}), old_resources
            )
        if new_name:
            self.nodepool_resources[new_name] = res.merge(
                self.nodepool_resources.get(new_name, {}), new_resources
            )
        for name in (old_name, new_name):
            if name and res.is_zero(self.nodepool_resources.get(name, {})):
                self.nodepool_resources.pop(name, None)

    def reset(self) -> None:
        self.__init__(self.clock, self.store, self.cloud_provider, self.nomination_window)
