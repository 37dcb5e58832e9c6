"""Task models."""

from raw2logit_tpu_torch.models.resnet import (  # noqa: F401
    RESNET_CONFIGS, BasicBlock, Bottleneck, FlaxBatchNorm2d, ResNet,
    resnet_model)
