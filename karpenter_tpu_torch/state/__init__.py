from karpenter_tpu_torch.state.cluster import Cluster  # noqa: F401
from karpenter_tpu_torch.state.statenode import PodBlockEvictionError, StateNode  # noqa: F401
