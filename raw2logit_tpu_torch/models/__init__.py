"""Task models: ResNet classifiers and U-Net++ segmenters (float32 or
bfloat16 compute), and the overlay of converted ImageNet weights."""

from raw2logit_tpu_torch.models.resnet import (  # noqa: F401
    PRETRAINED_SKIP, RESNET_CONFIGS, BasicBlock, Bottleneck, FlaxBatchNorm2d,
    ResNet, load_pretrained_npz, load_pretrained_variables,
    overlay_pretrained, resnet_model, stem_max_pool)
from raw2logit_tpu_torch.models.unetpp import UNetPlusPlus  # noqa: F401
