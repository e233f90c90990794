"""Cloud-provider plugin boundary (reference pkg/cloudprovider)."""

from karpenter_tpu_torch.cloudprovider.types import (  # noqa: F401
    CloudProvider,
    CreateError,
    InstanceType,
    InstanceTypeOverhead,
    InsufficientCapacityError,
    NodeClaimNotFoundError,
    NodeClassNotReadyError,
    Offering,
    Offerings,
    RepairPolicy,
)
