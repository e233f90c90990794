from karpenter_tpu_torch.events.recorder import Event, Recorder  # noqa: F401
