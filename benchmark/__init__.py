"""The benchmark of karpenter_tpu_torch on NVIDIA cards: `run.py` runs one cell."""
