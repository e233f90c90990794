from karpenter_tpu_torch.scheduler.scheduler import Results, Scheduler  # noqa: F401
