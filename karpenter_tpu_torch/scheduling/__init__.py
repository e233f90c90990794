"""Scheduling algebra library (reference: pkg/scheduling).

Pure, dependency-free set algebra over node-selector requirements, taints,
host ports and volume usage. This is the host-side semantic twin of the
array encoding in `karpenter_tpu_torch.ops` — property tests assert they agree.
"""

from karpenter_tpu_torch.scheduling.requirements import (  # noqa: F401
    Operator,
    Requirement,
    Requirements,
)
from karpenter_tpu_torch.scheduling.taints import Taint, Taints, Toleration  # noqa: F401
