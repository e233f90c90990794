"""State informers: pipe store watch events into Cluster.

The reference runs five thin controllers (pkg/controllers/state/informer/
{node,pod,nodeclaim,nodepool,daemonset}.go) fed by the controller-runtime
cache. Here a single informer drains one watch subscription and dispatches
per kind — same ingestion semantics, one linearized stream.
"""

from __future__ import annotations

import copy

from karpenter_tpu_torch.runtime.store import ADDED, DELETED, MODIFIED, Event, Store
from karpenter_tpu_torch.state.cluster import Cluster

WATCHED_KINDS = ("Node", "Pod", "NodeClaim", "NodePool", "DaemonSet")


class StateInformer:
    def __init__(self, store: Store, cluster: Cluster):
        self.store = store
        self.cluster = cluster
        self._watch = store.watch(WATCHED_KINDS)

    def flush(self) -> int:
        """Apply all pending watch events to cluster state; returns count."""
        events = self._watch.drain()
        for event in events:
            self._apply(event)
        return len(events)

    def bootstrap(self) -> int:
        """Replay every object already in the store into cluster state.

        The watch subscription carries events from construction onward
        only — an operator booted onto a POPULATED store (crash restart,
        adoption of an existing cluster) would otherwise plan against an
        empty Cluster: the scheduler re-provisions capacity that already
        exists and consolidation sees nothing to fold. Kind order matters:
        nodes land before the pods bound to them. Idempotent (cluster
        updates are upserts), so replaying on a warm informer is harmless;
        returns the number of objects replayed."""
        count = 0
        for kind in WATCHED_KINDS:
            for obj in self.store.list(kind):
                self._apply(Event(ADDED, kind, obj))
                count += 1
        return count

    def _apply(self, event: Event) -> None:
        obj = event.obj
        kind = event.kind
        if kind == "Node":
            if event.type == DELETED:
                self.cluster.delete_node(obj.metadata.name)
            else:
                # Snapshot: the store shares objects by reference and
                # controllers mutate them in place, but Cluster diffing
                # (nodepool resource accounting, consolidation triggers,
                # cluster.go:600-646/857-874) needs the PREVIOUS state to
                # stay distinct — real informers deliver fresh object
                # versions per event. Pods skip this (their diffing keys off
                # the bindings map, and they dominate event volume).
                self.cluster.update_node(copy.deepcopy(obj))
        elif kind == "Pod":
            if event.type == DELETED:
                self.cluster.delete_pod(obj.metadata.namespace, obj.metadata.name)
            else:
                self.cluster.update_pod(obj)
        elif kind == "NodeClaim":
            if event.type == DELETED:
                self.cluster.delete_node_claim(obj.metadata.name)
            else:
                self.cluster.update_node_claim(copy.deepcopy(obj))
        elif kind == "NodePool":
            # NodePool changes invalidate consolidation decisions
            # (informer/nodepool.go:45-55).
            self.cluster.mark_unconsolidated()
        elif kind == "DaemonSet":
            if event.type == DELETED:
                self.cluster.delete_daemonset(obj.metadata.namespace, obj.metadata.name)
            else:
                self.cluster.update_daemonset(obj)
