"""Overlay-applying CloudProvider decorator.

Wrapped around any provider at the operator boundary when the NodeOverlay
feature gate is on, so EVERY instance-type consumer — provisioning,
consolidation simulation, drift detection, nodepool counters — sees the
same overlay-adjusted catalog. Applying per-consumer instead would let
consolidation price nodes differently than the provisioning pass that
launched them (churn loops). Launch-side application is the provider's own
concern (kwok honors overlays in create when told to).
"""

from __future__ import annotations

from karpenter_tpu_torch.apis.nodeoverlay import OverlayApplier


class OverlayedCloudProvider:
    """Delegates everything to the wrapped provider; get_instance_types
    returns overlay-adjusted copies (memoized in OverlayApplier so object
    identity is stable across passes for downstream id-keyed caches)."""

    def __init__(self, inner, store):
        self._inner = inner
        self._applier = OverlayApplier(store)

    def get_instance_types(self, node_pool):
        return self._applier.apply(
            node_pool, self._inner.get_instance_types(node_pool)
        )

    def __getattr__(self, name):
        # see MetricsCloudProvider.__getattr__: never delegate the delegate
        # attribute itself (unpickling calls __getattr__ before __dict__ is
        # restored and would recurse)
        if name == "_inner":
            raise AttributeError(name)
        return getattr(self._inner, name)
