"""Taint/toleration checks (reference pkg/scheduling/taints.go:33-81)."""

from __future__ import annotations

from typing import Iterable, Optional

from karpenter_tpu_torch.apis import labels as well_known
from karpenter_tpu_torch.apis.core import NO_EXECUTE, NO_SCHEDULE, Pod, Taint, Toleration

UNREGISTERED_NO_EXECUTE_TAINT = Taint(
    key=well_known.UNREGISTERED_TAINT_KEY, effect=NO_EXECUTE
)
DISRUPTED_NO_SCHEDULE_TAINT = Taint(key=well_known.DISRUPTED_TAINT_KEY, effect=NO_SCHEDULE)

# Taints expected on a node while it initializes; ignored on uninitialized
# managed nodes (reference taints.go:36-42).
KNOWN_EPHEMERAL_TAINTS: tuple[Taint, ...] = (
    Taint(key=well_known.TAINT_NODE_NOT_READY, effect=NO_SCHEDULE),
    Taint(key=well_known.TAINT_NODE_NOT_READY, effect=NO_EXECUTE),
    Taint(key=well_known.TAINT_NODE_UNREACHABLE, effect=NO_SCHEDULE),
    Taint(key=well_known.TAINT_EXTERNAL_CLOUD_PROVIDER, effect=NO_SCHEDULE, value="true"),
    UNREGISTERED_NO_EXECUTE_TAINT,
)


class Taints(list):
    """Decorated taint list (reference taints.go:45-80)."""

    def tolerates_pod(self, pod: Pod) -> Optional[str]:
        return self.tolerates(pod.spec.tolerations)

    def tolerates(self, tolerations: Iterable[Toleration]) -> Optional[str]:
        """None if every taint is tolerated, else an error string."""
        errs = []
        for taint in self:
            if not any(t.tolerates(taint) for t in tolerations):
                errs.append(
                    f"did not tolerate taint {taint.key}={taint.value}:{taint.effect}"
                )
        return "; ".join(errs) if errs else None

    def merge(self, with_taints: Iterable[Taint]) -> "Taints":
        """Union keeping self's entry on (key, effect) conflicts."""
        out = Taints(self)
        for taint in with_taints:
            if not any(taint.match(t) for t in out):
                out.append(taint)
        return out
