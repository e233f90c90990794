"""NodeOverlay runtime validation controller.

Mirrors the reference's runtime-validation pattern for alpha CRDs
(pkg/apis/v1alpha1/nodeoverlay_validation.go semantics behind the
NodeOverlay feature gate): each overlay gets a ValidationSucceeded
condition; invalid overlays are skipped by apply_overlays regardless, so
the condition is operator-facing signal, not enforcement.
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.nodeoverlay import (
    CONDITION_VALIDATION_SUCCEEDED,
    NodeOverlay,
)
from karpenter_tpu_torch.runtime.store import Store
from karpenter_tpu_torch.utils.clock import Clock


class NodeOverlayValidationController:
    def __init__(self, store: Store, clock: Clock):
        self.store = store
        self.clock = clock

    def reconcile(self, overlay: NodeOverlay) -> None:
        err = overlay.validate()
        now = self.clock.now()
        if err is None:
            overlay.set_condition(CONDITION_VALIDATION_SUCCEEDED, "True", now=now)
        else:
            overlay.set_condition(
                CONDITION_VALIDATION_SUCCEEDED,
                "False",
                reason="ValidationFailed",
                message=err,
                now=now,
            )
        self.store.apply(overlay)

    def reconcile_all(self) -> None:
        for overlay in self.store.list(NodeOverlay.KIND):
            self.reconcile(overlay)
