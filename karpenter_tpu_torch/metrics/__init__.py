from karpenter_tpu_torch.metrics.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    Registry,
    Store,
    global_registry,
    measure,
)
