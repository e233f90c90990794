"""PodDisruptionBudget eviction limits.

Mirrors the reference's pkg/utils/pdb/pdb.go:44-180: can a set of pods be
evicted, and is a pod blocked from rescheduling by a fully-blocking PDB.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from karpenter_tpu_torch.apis.core import Pod, PodDisruptionBudget
from karpenter_tpu_torch.utils import pod as podutil

_ZERO_DISRUPTIONS = 0
_FULLY_BLOCKING = 1


@dataclass
class _PdbItem:
    key: tuple[str, str]  # (namespace, name)
    pdb: PodDisruptionBudget
    disruptions_allowed: int
    is_fully_blocking: bool
    can_always_evict_unhealthy: bool


def _new_item(pdb: PodDisruptionBudget) -> _PdbItem:
    spec = pdb.spec
    fully_blocking = (
        spec.max_unavailable in (0, "0", "0%")
        or spec.min_available == "100%"
    )
    return _PdbItem(
        key=(pdb.metadata.namespace, pdb.metadata.name),
        pdb=pdb,
        disruptions_allowed=pdb.status.disruptions_allowed,
        is_fully_blocking=fully_blocking,
        can_always_evict_unhealthy=getattr(
            spec, "unhealthy_pod_eviction_policy", None
        ) == "AlwaysAllow",
    )


class Limits(list):
    """Evaluates whether evicting pods is possible under current PDBs."""

    @classmethod
    def from_pdbs(cls, pdbs: Sequence[PodDisruptionBudget]) -> "Limits":
        return cls(_new_item(p) for p in pdbs)

    def _is_evictable(self, pod: Pod, blocker: int) -> tuple[list, bool]:
        # Non-evictable pods never hit the eviction API, so PDBs don't matter.
        if not podutil.is_evictable(pod):
            return [], True
        matching = [
            item
            for item in self
            if item.key[0] == pod.metadata.namespace
            and item.pdb.spec.selector.matches(pod.metadata.labels)
        ]
        # Kubernetes rejects eviction when >1 PDB matches a pod.
        if len(matching) > 1:
            return [i.key for i in matching], False
        for item in matching:
            if item.can_always_evict_unhealthy and any(
                c.type == "Ready" and c.status == "False"
                for c in pod.status.conditions
            ):
                return [], True
            if blocker == _ZERO_DISRUPTIONS and item.disruptions_allowed == 0:
                return [item.key], False
            if blocker == _FULLY_BLOCKING and item.is_fully_blocking:
                return [item.key], False
        return [], True

    def can_evict_pods(self, pods: Sequence[Pod]) -> tuple[list, bool]:
        """True if every pod has >0 disruptions allowed (pdb.go:63-74)."""
        for pod in pods:
            keys, ok = self._is_evictable(pod, _ZERO_DISRUPTIONS)
            if not ok:
                return keys, False
        return [], True

    def is_fully_blocked(self, pod: Pod) -> tuple[list, bool]:
        keys, ok = self._is_evictable(pod, _FULLY_BLOCKING)
        return (keys, True) if not ok else ([], False)

    def is_currently_reschedulable(self, pod: Pod) -> bool:
        """Reschedulable AND not pinned by do-not-disrupt or a fully blocking
        PDB (pdb.go:131-146): don't provision capacity for pods that can't
        actually leave their node."""
        _, blocked = self.is_fully_blocked(pod)
        return (
            podutil.is_reschedulable(pod)
            and not podutil.has_do_not_disrupt(pod)
            and not blocked
        )
