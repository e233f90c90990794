"""CSI volume-attach-limit accounting per simulated node.

Mirrors the reference's pkg/scheduling/volumeusage.go:43-236: pods' PVC-backed
volumes are resolved to a CSI driver (via bound PV or StorageClass
provisioner) and counted against per-driver attach limits from CSINode.
"""

from __future__ import annotations

from typing import Optional

from karpenter_tpu_torch.apis.core import Pod
from karpenter_tpu_torch.runtime.store import NotFound, Store

# In-tree provisioner names translated to their CSI equivalents
# (csi-translation-lib; only the ones the reference's tests exercise).
IN_TREE_TO_CSI = {
    "kubernetes.io/aws-ebs": "ebs.csi.aws.com",
    "kubernetes.io/gce-pd": "pd.csi.storage.gke.io",
    "kubernetes.io/azure-disk": "disk.csi.azure.com",
}


class Volumes(dict):
    """driver name → set of PVC ids (volumeusage.go:43-79)."""

    def add(self, driver: str, pvc_id: str) -> None:
        self.setdefault(driver, set()).add(pvc_id)

    def union(self, other: "Volumes") -> "Volumes":
        out = Volumes({k: set(v) for k, v in self.items()})
        for k, v in other.items():
            out.setdefault(k, set()).update(v)
        return out

    def insert(self, other: "Volumes") -> None:
        for k, v in other.items():
            self.setdefault(k, set()).update(v)


def _driver_from_volume(store: Store, volume_name: str) -> str:
    try:
        pv = store.get("PersistentVolume", volume_name)
    except NotFound:
        return ""
    return pv.csi_driver or ""


def _driver_from_storage_class(store: Store, name: str) -> Optional[str]:
    try:
        sc = store.get("StorageClass", name)
    except NotFound:
        return None
    return IN_TREE_TO_CSI.get(sc.provisioner, sc.provisioner)


def get_volumes(store: Store, pod: Pod) -> Volumes:
    """Resolve a pod's PVC-backed volumes to CSI drivers
    (volumeusage.go:81-109). Missing PVCs/StorageClasses are skipped, not
    errors — they were manually deleted and shouldn't wedge cluster state."""
    out = Volumes()
    for volume in pod.spec.volumes:
        claim_name = volume.persistent_volume_claim
        if claim_name is None and volume.ephemeral_storage_class is None:
            continue
        if claim_name is not None:
            pvc = store.try_get("PersistentVolumeClaim", claim_name, pod.metadata.namespace)
            if pvc is None:
                continue
            if pvc.volume_name:
                driver = _driver_from_volume(store, pvc.volume_name)
                if driver:
                    out.add(driver, f"{pod.metadata.namespace}/{claim_name}")
                continue
            sc_name = pvc.storage_class_name or ""
        else:
            # generic ephemeral volume: PVC named <pod>-<volume> with the
            # given storage class
            sc_name = volume.ephemeral_storage_class
            claim_name = f"{pod.metadata.name}-{volume.name}"
        if not sc_name:
            continue
        driver = _driver_from_storage_class(store, sc_name)
        if driver:
            out.add(driver, f"{pod.metadata.namespace}/{claim_name}")
    return out


class VolumeUsage:
    """Per-node volume usage vs driver limits (volumeusage.go:188-236)."""

    def __init__(self):
        self._volumes = Volumes()
        self._pod_volumes: dict[tuple[str, str], Volumes] = {}
        self._limits: dict[str, int] = {}

    def add_limit(self, driver: str, value: int) -> None:
        self._limits[driver] = value

    def copy(self) -> "VolumeUsage":
        """Independent copy for simulations (pvc-id sets copied)."""
        out = VolumeUsage()
        out._volumes = Volumes({k: set(v) for k, v in self._volumes.items()})
        out._pod_volumes = {
            pk: Volumes({k: set(v) for k, v in vols.items()})
            for pk, vols in self._pod_volumes.items()
        }
        out._limits = dict(self._limits)
        return out

    def exceeds_limits(self, vols: Volumes) -> Optional[str]:
        for driver, pvc_ids in self._volumes.union(vols).items():
            limit = self._limits.get(driver)
            if limit is not None and len(pvc_ids) > limit:
                return (
                    f"would exceed volume limit for driver {driver}: "
                    f"{len(pvc_ids)} > {limit}"
                )
        return None

    def add(self, pod: Pod, vols: Volumes) -> None:
        self._pod_volumes[(pod.metadata.namespace, pod.metadata.name)] = vols
        self._volumes = self._volumes.union(vols)

    def delete_pod(self, namespace: str, name: str) -> None:
        self._pod_volumes.pop((namespace, name), None)
        self._volumes = Volumes()
        for vols in self._pod_volumes.values():
            self._volumes.insert(vols)
