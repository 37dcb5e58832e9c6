"""Task models: ResNet classifiers and U-Net++ segmenters."""

from raw2logit_tpu_torch.models.resnet import (  # noqa: F401
    RESNET_CONFIGS, BasicBlock, Bottleneck, FlaxBatchNorm2d, ResNet,
    resnet_model)
from raw2logit_tpu_torch.models.unetpp import UNetPlusPlus  # noqa: F401
