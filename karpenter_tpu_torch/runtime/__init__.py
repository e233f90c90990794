from karpenter_tpu_torch.runtime.store import Event, Store  # noqa: F401
