"""Metrics controllers: pod / node / nodepool gauge stores.

Mirrors controllers/metrics/{pod,node,nodepool}/controller.go — per-object
gauge families replaced atomically via metrics.Store so deleted objects'
series disappear.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.metrics import Store as MetricStore
from karpenter_tpu_torch.metrics import global_registry
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.state.cluster import Cluster
from karpenter_tpu_torch.utils import pod as podutil
from karpenter_tpu_torch.utils.clock import Clock

_POD_STATE = global_registry.gauge(
    "karpenter_pods_state", "pod state", labels=["name", "namespace", "phase", "node"]
)
_POD_STARTUP = global_registry.histogram(
    "karpenter_pods_startup_duration_seconds", "time from pod creation to running"
)
_POD_UNBOUND = global_registry.histogram(
    "karpenter_pods_unbound_duration_seconds", "time pods spend unbound"
)
# the rest of the reference's pod metric family (metrics/pod/controller.go
# :60-165): live per-pod gauges (deleted when the state resolves or the pod
# goes away) + once-per-transition histograms, each with a provisioning_*
# twin measured from the time karpenter first deemed the pod schedulable
_POD_LABELS = ["name", "namespace"]
_POD_UNSTARTED = global_registry.gauge(
    "karpenter_pods_unstarted_time_seconds",
    "time pods have spent not running since creation",
    labels=_POD_LABELS,
)
_POD_BOUND_DURATION = global_registry.histogram(
    "karpenter_pods_bound_duration_seconds", "time from pod creation to bound"
)
_POD_UNBOUND_TIME = global_registry.gauge(
    "karpenter_pods_unbound_time_seconds",
    "time pods have spent unbound since creation",
    labels=_POD_LABELS,
)
_POD_PROV_BOUND = global_registry.histogram(
    "karpenter_pods_provisioning_bound_duration_seconds",
    "time from schedulability determination to bound",
)
_POD_PROV_UNBOUND = global_registry.gauge(
    "karpenter_pods_provisioning_unbound_time_seconds",
    "time provisioned pods have spent unbound since schedulability",
    labels=_POD_LABELS,
)
_POD_PROV_STARTUP = global_registry.histogram(
    "karpenter_pods_provisioning_startup_duration_seconds",
    "time from schedulability determination to running",
)
_POD_PROV_UNSTARTED = global_registry.gauge(
    "karpenter_pods_provisioning_unstarted_time_seconds",
    "time provisioned pods have spent not running since schedulability",
    labels=_POD_LABELS,
)
_POD_UNDECIDED = global_registry.gauge(
    "karpenter_pods_scheduling_undecided_time_seconds",
    "time since ack for pods with no scheduling decision yet",
    labels=_POD_LABELS,
)
_NODE_LABELS = ["node_name", "nodepool", "resource_type"]
_NODE_ALLOCATABLE = global_registry.gauge(
    "karpenter_nodes_allocatable", "node allocatable", labels=_NODE_LABELS
)
_NODE_UTILIZATION = global_registry.gauge(
    "karpenter_nodes_total_pod_requests", "node pod requests", labels=_NODE_LABELS
)
# the rest of the reference's node series (metrics/node/controller.go:60-140)
_NODE_POD_LIMITS = global_registry.gauge(
    "karpenter_nodes_total_pod_limits", "node pod limits", labels=_NODE_LABELS
)
_NODE_DAEMON_REQUESTS = global_registry.gauge(
    "karpenter_nodes_total_daemon_requests", "node daemonset requests",
    labels=_NODE_LABELS,
)
_NODE_DAEMON_LIMITS = global_registry.gauge(
    "karpenter_nodes_total_daemon_limits", "node daemonset limits",
    labels=_NODE_LABELS,
)
_NODE_SYSTEM_OVERHEAD = global_registry.gauge(
    "karpenter_nodes_system_overhead", "capacity minus allocatable",
    labels=_NODE_LABELS,
)
_NODE_LIFETIME_GAUGE = global_registry.gauge(
    "karpenter_nodes_current_lifetime_seconds", "node age",
    labels=["node_name", "nodepool"],
)
_NODE_UTIL_PCT = global_registry.gauge(
    "karpenter_nodes_utilization_percent",
    "pod requests as a percentage of allocatable",
    labels=_NODE_LABELS,
)
_NODEPOOL_LIMIT = global_registry.gauge(
    "karpenter_nodepools_limit", "nodepool limits", labels=["nodepool", "resource_type"]
)
_NODEPOOL_USAGE = global_registry.gauge(
    "karpenter_nodepools_usage", "nodepool usage", labels=["nodepool", "resource_type"]
)
_CONDITION_COUNT = global_registry.gauge(
    "karpenter_status_condition_count",
    "objects currently holding each status-condition state",
    labels=["kind", "type", "status", "reason"],
)


class PodMetricsController:
    def __init__(self, store: Store, cluster: Cluster, clock: Clock):
        self.store = store
        self.cluster = cluster
        self.clock = clock
        self.metric_store = MetricStore()
        self._started: set[str] = set()
        self._bound: set[str] = set()

    def reconcile(self) -> None:
        now = self.clock.now()
        for pod in self.store.list("Pod"):
            key = f"pod/{pod.metadata.namespace}/{pod.metadata.name}"
            nn = (pod.metadata.namespace, pod.metadata.name)
            plabels = {"name": pod.metadata.name, "namespace": pod.metadata.namespace}
            self.metric_store.update(
                key,
                [
                    (
                        _POD_STATE,
                        {
                            "name": pod.metadata.name,
                            "namespace": pod.metadata.namespace,
                            "phase": pod.status.phase,
                            "node": pod.spec.node_name,
                        },
                        1.0,
                    )
                ],
            )
            # schedulable time: when karpenter first deemed this pod
            # schedulable (zero if it never went through provisioning)
            schedulable = self.cluster.pod_scheduling_success_time(nn)
            bound = bool(pod.spec.node_name)
            if pod.status.phase == "Running" and pod.metadata.uid not in self._started:
                self._started.add(pod.metadata.uid)
                _POD_STARTUP.observe(now - pod.metadata.creation_timestamp)
                if schedulable > 0.0:
                    _POD_PROV_STARTUP.observe(now - schedulable)
            if pod.metadata.uid in self._started or podutil.is_terminal(pod):
                _POD_UNSTARTED.delete(plabels)
                _POD_PROV_UNSTARTED.delete(plabels)
            else:
                _POD_UNSTARTED.set(now - pod.metadata.creation_timestamp, plabels)
                if schedulable > 0.0:
                    _POD_PROV_UNSTARTED.set(now - schedulable, plabels)
            if bound:
                if pod.metadata.uid not in self._bound:
                    self._bound.add(pod.metadata.uid)
                    _POD_BOUND_DURATION.observe(
                        now - pod.metadata.creation_timestamp
                    )
                    if schedulable > 0.0:
                        _POD_PROV_BOUND.observe(now - schedulable)
                _POD_UNBOUND_TIME.delete(plabels)
                _POD_PROV_UNBOUND.delete(plabels)
            else:
                _POD_UNBOUND_TIME.set(now - pod.metadata.creation_timestamp, plabels)
                if schedulable > 0.0:
                    _POD_PROV_UNBOUND.set(now - schedulable, plabels)
            # undecided: ack'd by the provisioner but no decision recorded
            # and not yet bound (metrics/pod/controller.go:263-284)
            decision = self.cluster.pod_scheduling_decision_time(nn)
            ack = self.cluster.pod_ack_time(nn)
            if bound or decision > 0.0 or ack <= 0.0:
                _POD_UNDECIDED.delete(plabels)
            else:
                _POD_UNDECIDED.set(now - ack, plabels)

    def on_delete(self, namespace: str, name: str) -> None:
        self.metric_store.delete(f"pod/{namespace}/{name}")
        plabels = {"name": name, "namespace": namespace}
        for gauge in (
            _POD_UNSTARTED,
            _POD_PROV_UNSTARTED,
            _POD_UNBOUND_TIME,
            _POD_PROV_UNBOUND,
            _POD_UNDECIDED,
        ):
            gauge.delete(plabels)


class NodeMetricsController:
    def __init__(self, cluster: Cluster, store: Store = None, clock: Clock = None):
        self.cluster = cluster
        self.store = store
        self.clock = clock
        self.metric_store = MetricStore()

    def reconcile(self) -> None:
        from karpenter_tpu_torch.apis.core import pod_resource_limits
        from karpenter_tpu_torch.utils import resources as res
        from karpenter_tpu_torch.utils.pod import is_owned_by_daemon_set

        for sn in self.cluster.state_nodes():
            pool = sn.labels().get(wk.NODEPOOL_LABEL_KEY, "")
            name = sn.name()
            series = []

            def rows(gauge, values):
                for resource, value in values.items():
                    series.append(
                        (
                            gauge,
                            {
                                "node_name": name,
                                "nodepool": pool,
                                "resource_type": resource,
                            },
                            value,
                        )
                    )

            allocatable = sn.allocatable()
            requests = sn.total_pod_requests()
            rows(_NODE_ALLOCATABLE, allocatable)
            rows(_NODE_UTILIZATION, requests)
            rows(_NODE_DAEMON_REQUESTS, sn.total_daemonset_requests())
            rows(
                _NODE_SYSTEM_OVERHEAD,
                res.subtract(sn.capacity(), allocatable),
            )
            rows(
                _NODE_UTIL_PCT,
                {
                    k: 100.0 * v / allocatable[k]
                    for k, v in requests.items()
                    if allocatable.get(k, 0.0) > 0.0
                },
            )
            if self.store is not None:
                pod_limits: dict = {}
                daemon_limits: dict = {}
                for p in self.store.pods_on_node(name):
                    limits = pod_resource_limits(p)
                    pod_limits = res.merge(pod_limits, limits)
                    if is_owned_by_daemon_set(p):
                        daemon_limits = res.merge(daemon_limits, limits)
                rows(_NODE_POD_LIMITS, pod_limits)
                rows(_NODE_DAEMON_LIMITS, daemon_limits)
            if self.clock is not None and sn.node is not None:
                series.append(
                    (
                        _NODE_LIFETIME_GAUGE,
                        {"node_name": name, "nodepool": pool},
                        self.clock.now() - sn.node.metadata.creation_timestamp,
                    )
                )
            self.metric_store.update(f"node/{name}", series)


class StatusConditionMetricsController:
    """Condition-count gauges per CRD — the TPU-native stand-in for the
    three operatorpkg status controllers the reference registry wires
    (controllers.go:102-120). Each reconcile rebuilds the whole family
    atomically, so conditions that disappear (object deleted, condition
    cleared) drop their series. Transition totals/durations are emitted
    at the set_condition chokepoint (apis/conditions.py)."""

    KINDS = ("NodeClaim", "NodePool", "NodeOverlay")

    def __init__(self, store: Store):
        self.store = store
        self.metric_store = MetricStore()

    def reconcile(self) -> None:
        counts: dict[tuple[str, str, str, str], int] = {}
        for kind in self.KINDS:
            for obj in self.store.list(kind):
                for c in obj.status.conditions:
                    key = (kind, c.type, c.status, c.reason)
                    counts[key] = counts.get(key, 0) + 1
        self.metric_store.update(
            "status-conditions",
            [
                (
                    _CONDITION_COUNT,
                    {"kind": k, "type": t, "status": s, "reason": r},
                    float(n),
                )
                for (k, t, s, r), n in counts.items()
            ],
        )


class NodePoolMetricsController:
    def __init__(self, store: Store, cluster: Cluster):
        self.store = store
        self.cluster = cluster
        self.metric_store = MetricStore()

    def reconcile(self) -> None:
        for pool in self.store.list("NodePool"):
            name = pool.metadata.name
            series = []
            for resource, value in pool.spec.limits.items():
                series.append(
                    (_NODEPOOL_LIMIT, {"nodepool": name, "resource_type": resource}, value)
                )
            for resource, value in self.cluster.nodepool_resources_for(name).items():
                series.append(
                    (_NODEPOOL_USAGE, {"nodepool": name, "resource_type": resource}, value)
                )
            self.metric_store.update(f"nodepool/{name}", series)
