"""In-memory object store: the framework's durable-state substrate.

The reference treats the Kubernetes API server as the single durable store —
all in-memory state is rebuilt from watches (SURVEY.md §5 "Checkpoint /
resume"). This store plays that role for the TPU build: versioned objects,
finalizer-aware deletion, and synchronous watch fan-out that informers and
controllers subscribe to. Semantics mirror apimachinery where the reference
depends on them:

- resourceVersion bumps on every write (optimistic concurrency available via
  `update(..., expect_version=)` like controller-runtime's optimistic-lock
  patch, lifecycle/controller.go:127-133)
- delete with finalizers present only sets deletionTimestamp; the object is
  removed when the last finalizer is stripped
- watch events are delivered synchronously in write order, so a controller
  loop draining the queue sees a linearized history (the reference's informer
  cache gives the same guarantee per object)
"""

from __future__ import annotations

import copy
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from karpenter_tpu_torch.utils.clock import Clock

ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass
class Event:
    type: str  # ADDED | MODIFIED | DELETED
    kind: str
    obj: Any


class Conflict(Exception):
    """Optimistic-concurrency failure (apimachinery 409)."""


class NotFound(Exception):
    pass


class AlreadyExists(Exception):
    pass


def _key(obj: Any) -> tuple[str, str]:
    return (obj.metadata.namespace, obj.metadata.name)


class Watch:
    """A subscription delivering events for a set of kinds."""

    def __init__(self, kinds: Optional[set[str]] = None):
        self.kinds = kinds
        self.queue: deque[Event] = deque()

    def _offer(self, event: Event) -> None:
        if self.kinds is None or event.kind in self.kinds:
            self.queue.append(event)

    def drain(self) -> list[Event]:
        out = list(self.queue)
        self.queue.clear()
        return out

    def __len__(self) -> int:
        return len(self.queue)


class Store:
    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self._objects: dict[str, dict[tuple[str, str], Any]] = {}
        self._watches: list[Watch] = []
        self._version = 0
        # repr snapshots backing apply()'s update-if-changed guard
        self._applied_repr: dict[tuple[str, tuple[str, str]], str] = {}
        # pod-by-node field index (the reference registers a field indexer
        # for exactly this query, operator.go:235-278): candidate discovery
        # asks "pods on node X" once per node per pass, which would be
        # O(nodes x pods) as a predicate scan
        self._pod_node: dict[tuple[str, str], str] = {}
        # inner dict used as an insertion-ordered set: iteration order is
        # deterministic (a real set would hash-randomize pod order)
        self._node_pods: dict[str, dict[tuple[str, str], None]] = {}

    # -- watches -----------------------------------------------------------

    def watch(self, kinds: Optional[Iterable[str]] = None) -> Watch:
        w = Watch(set(kinds) if kinds is not None else None)
        self._watches.append(w)
        return w

    def _emit(self, type_: str, obj: Any) -> None:
        event = Event(type_, obj.KIND, obj)
        for w in self._watches:
            w._offer(event)

    # -- CRUD --------------------------------------------------------------

    def create(self, obj: Any) -> Any:
        kind = obj.KIND
        bucket = self._objects.setdefault(kind, {})
        key = _key(obj)
        if key in bucket:
            raise AlreadyExists(f"{kind} {key} already exists")
        self._version += 1
        obj.metadata.resource_version = self._version
        if not obj.metadata.creation_timestamp:
            obj.metadata.creation_timestamp = self.clock.now()
        bucket[key] = obj
        # Keep the apply() snapshot current: the DeepEqual guard compares
        # against the object's latest written state, not the last patch.
        self._applied_repr[(kind, key)] = repr(obj)
        if kind == "Pod":
            self._index_pod(key, obj)
        self._emit(ADDED, obj)
        return obj

    def get(self, kind: str, name: str, namespace: str = "default") -> Any:
        obj = self._objects.get(kind, {}).get((namespace, name))
        if obj is None:
            raise NotFound(f"{kind} {namespace}/{name} not found")
        return obj

    def try_get(self, kind: str, name: str, namespace: str = "default") -> Optional[Any]:
        return self._objects.get(kind, {}).get((namespace, name))

    def list(
        self,
        kind: str,
        namespace: Optional[str] = None,
        predicate: Optional[Callable[[Any], bool]] = None,
    ) -> list[Any]:
        out = []
        for (ns, _), obj in self._objects.get(kind, {}).items():
            if namespace is not None and ns != namespace:
                continue
            if predicate is not None and not predicate(obj):
                continue
            out.append(obj)
        return out

    def update(self, obj: Any, expect_version: Optional[int] = None) -> Any:
        bucket = self._objects.get(obj.KIND, {})
        key = _key(obj)
        current = bucket.get(key)
        if current is None:
            raise NotFound(f"{obj.KIND} {key} not found")
        if expect_version is not None and current.metadata.resource_version != expect_version:
            raise Conflict(
                f"{obj.KIND} {key}: version {current.metadata.resource_version} "
                f"!= expected {expect_version}"
            )
        self._version += 1
        obj.metadata.resource_version = self._version
        bucket[key] = obj
        # Refresh the apply() snapshot: an interleaved update() that mutates
        # an object must not let a later apply() suppress the revert (the
        # reference's DeepEqual guard compares against the stored object).
        self._applied_repr[(obj.KIND, key)] = repr(obj)
        if obj.KIND == "Pod":
            self._index_pod(key, obj)
        self._emit(MODIFIED, obj)
        # Deleting object whose finalizers were all stripped is removed now.
        if obj.metadata.deletion_timestamp is not None and not obj.metadata.finalizers:
            self._remove(obj)
        return obj

    def touch(self, obj: Any) -> Any:
        """Update an object mutated in place (the common controller path)."""
        return self.update(obj)

    def apply(self, obj: Any) -> Any:
        """Update-if-changed: the reference guards every Patch with
        equality.Semantic.DeepEqual so idempotent reconcilers don't re-emit
        watch events and re-trigger themselves. Reconcile paths use this;
        `update` keeps the strict always-bump apimachinery contract."""
        key = (obj.KIND, _key(obj))
        new_repr = repr(obj)
        if self._applied_repr.get(key) == new_repr and _key(obj) in self._objects.get(
            obj.KIND, {}
        ):
            return obj
        out = self.update(obj)
        # update() may have auto-removed the object (deletion_timestamp set,
        # finalizers empty) — don't resurrect an orphaned snapshot.
        if _key(obj) in self._objects.get(obj.KIND, {}):
            self._applied_repr[key] = repr(obj)
        else:
            self._applied_repr.pop(key, None)
        return out

    def delete(self, obj_or_kind: Any, name: str = "", namespace: str = "default") -> None:
        """Finalizer-aware delete (apimachinery graceful deletion)."""
        if isinstance(obj_or_kind, str):
            obj = self.get(obj_or_kind, name, namespace)
        else:
            obj = self._objects.get(obj_or_kind.KIND, {}).get(_key(obj_or_kind))
            if obj is None:
                raise NotFound(f"{obj_or_kind.KIND} {_key(obj_or_kind)} not found")
        if obj.metadata.finalizers:
            if obj.metadata.deletion_timestamp is None:
                obj.metadata.deletion_timestamp = self.clock.now()
                self._version += 1
                obj.metadata.resource_version = self._version
                self._emit(MODIFIED, obj)
            return
        self._remove(obj)

    def _remove(self, obj: Any) -> None:
        bucket = self._objects.get(obj.KIND, {})
        if bucket.pop(_key(obj), None) is not None:
            self._version += 1
            self._applied_repr.pop((obj.KIND, _key(obj)), None)
            if obj.KIND == "Pod":
                self._index_pod(_key(obj), None)
            self._emit(DELETED, obj)

    def _index_pod(self, key: tuple[str, str], obj: Optional[Any]) -> None:
        node_name = obj.spec.node_name if obj is not None else ""
        old = self._pod_node.get(key)
        if old == node_name:
            return
        if old:
            self._node_pods.get(old, {}).pop(key, None)
        if node_name:
            self._pod_node[key] = node_name
            self._node_pods.setdefault(node_name, {})[key] = None
        else:
            self._pod_node.pop(key, None)

    def pods_on_node(self, node_name: str) -> list[Any]:
        """Indexed equivalent of list("Pod", node_name predicate). Pods
        whose node_name changed WITHOUT a store write are filtered here but
        only re-indexed on their next write (same staleness window as the
        reference's informer-cache indexer)."""
        bucket = self._objects.get("Pod", {})
        out = []
        for key in self._node_pods.get(node_name, ()):
            p = bucket.get(key)
            if p is not None and p.spec.node_name == node_name:
                out.append(p)
        return out

    def remove_finalizer(self, obj: Any, finalizer: str) -> None:
        if finalizer in obj.metadata.finalizers:
            obj.metadata.finalizers = [
                f for f in obj.metadata.finalizers if f != finalizer
            ]
            self.update(obj)

    def deepcopy(self, obj: Any) -> Any:
        return copy.deepcopy(obj)

    @property
    def resource_version(self) -> int:
        return self._version
