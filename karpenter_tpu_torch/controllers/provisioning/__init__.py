from karpenter_tpu_torch.controllers.provisioning.provisioner import Provisioner  # noqa: F401
