"""Volume topology injection: PV/StorageClass zone constraints become pod
node-affinity requirements.

Mirrors the reference's scheduling/volumetopology.go:39-196.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis import labels as wk
from karpenter_tpu_torch.apis.core import (
    Affinity,
    NodeAffinity,
    NodeSelectorTerm,
    Pod,
    Volume,
)
from karpenter_tpu_torch.runtime.store import Store

UNSUPPORTED_PROVISIONERS: set[str] = set()


class VolumeTopology:
    def __init__(self, store: Store):
        self.store = store

    def inject(self, pod: Pod) -> None:
        """Append volume-derived requirements to every required node-affinity
        OR-term (volumetopology.go:46-80)."""
        requirements: list[dict] = []
        for volume in pod.spec.volumes:
            requirements.extend(self._requirements_for(pod, volume))
        if not requirements:
            return
        # in-place spec mutation invalidates the cached device-path shape
        # signatures (ops/ffd._raw_sig, ops/ffd_topo._topo_sig) and the
        # topology shape key (scheduler/topology._pod_shape_key)
        if hasattr(pod, "_kt_sig"):
            del pod._kt_sig
        if hasattr(pod, "_kt_tsig"):
            del pod._kt_tsig
        if hasattr(pod, "_kt_topo_key"):
            del pod._kt_topo_key
        if hasattr(pod, "_kt_topo_plain"):
            del pod._kt_topo_plain
        if pod.spec.affinity is None:
            pod.spec.affinity = Affinity()
        if pod.spec.affinity.node_affinity is None:
            pod.spec.affinity.node_affinity = NodeAffinity()
        if not pod.spec.affinity.node_affinity.required:
            pod.spec.affinity.node_affinity.required = [NodeSelectorTerm()]
        for term in pod.spec.affinity.node_affinity.required:
            term.match_expressions = list(term.match_expressions) + requirements

    def _pvc_for(self, pod: Pod, volume: Volume):
        claim_name = volume.persistent_volume_claim
        if claim_name is None:
            if volume.ephemeral_storage_class is not None:
                # Generic ephemeral volumes resolve like a PVC named
                # <pod>-<volume> with the given storage class.
                pvc = self.store.try_get(
                    "PersistentVolumeClaim",
                    f"{pod.metadata.name}-{volume.name}",
                    pod.metadata.namespace,
                )
                if pvc is not None:
                    return pvc
                return _EphemeralClaim(volume.ephemeral_storage_class)
            return None
        return self.store.try_get("PersistentVolumeClaim", claim_name, pod.metadata.namespace)

    def _requirements_for(self, pod: Pod, volume: Volume) -> list[dict]:
        pvc = self._pvc_for(pod, volume)
        if pvc is None:
            return []
        if getattr(pvc, "volume_name", ""):
            return self._pv_requirements(pvc.volume_name)
        sc_name = pvc.storage_class_name
        if sc_name:
            return self._storage_class_requirements(sc_name)
        return []

    def _storage_class_requirements(self, name: str) -> list[dict]:
        sc = self.store.try_get("StorageClass", name)
        if sc is None or not sc.allowed_topologies:
            return []
        return [
            {"key": e["key"], "operator": "In", "values": list(e.get("values", []))}
            for e in sc.allowed_topologies[0].match_expressions
        ]

    def _pv_requirements(self, volume_name: str) -> list[dict]:
        pv = self.store.try_get("PersistentVolume", volume_name)
        if pv is None or not pv.node_affinity_required:
            return []
        return list(pv.node_affinity_required[0].match_expressions)

    def validate_persistent_volume_claims(self, pod: Pod) -> Optional[str]:
        """Error string if a pod's PVC graph can't be resolved
        (volumetopology.go:146-181) — pods failing this are not provisionable."""
        for volume in pod.spec.volumes:
            pvc = self._pvc_for(pod, volume)
            if pvc is None:
                if volume.persistent_volume_claim is not None:
                    return f"pvc {volume.persistent_volume_claim} not found"
                continue
            if getattr(pvc, "volume_name", ""):
                if self.store.try_get("PersistentVolume", pvc.volume_name) is None:
                    return f"persistent volume {pvc.volume_name} not found"
                continue
            sc_name = pvc.storage_class_name
            if not sc_name:
                return "unbound pvc must define a storage class"
            sc = self.store.try_get("StorageClass", sc_name)
            if sc is None:
                return f"storage class {sc_name} not found"
            if sc.provisioner in UNSUPPORTED_PROVISIONERS:
                return f"storageClass provisioner {sc.provisioner} is not supported"
        return None


class _EphemeralClaim:
    """Placeholder PVC for a not-yet-created generic ephemeral volume."""

    volume_name = ""

    def __init__(self, storage_class_name: str):
        self.storage_class_name = storage_class_name
