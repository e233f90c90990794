from karpenter_tpu_torch.controllers.disruption.controller import Controller  # noqa: F401
from karpenter_tpu_torch.controllers.disruption.queue import Queue  # noqa: F401
from karpenter_tpu_torch.controllers.disruption.types import (  # noqa: F401
    Candidate,
    Command,
    DECISION_DELETE,
    DECISION_NOOP,
    DECISION_REPLACE,
)
