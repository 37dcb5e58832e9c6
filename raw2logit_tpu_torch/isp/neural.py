"""Neural ISP, ``processing_mode='neural_network'`` (port of
``raw2logit_tpu/isp/neural.py``): raw -> RGB by a small U-Net++ on the
packed mosaic.

Half-resolution 3-channel packing, the optional mosaic normalisation,
U-Net++ (resnet34 encoder, depth 3, decoder (256, 128, 64), 3 -> 3
channels) and the affine-free output batch norm.
"""

import torch.nn as nn

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.isp.batchnorm import TorchBatchNorm
from raw2logit_tpu_torch.isp.identity import (normalise_mosaic,
                                           register_mosaic_stats)
from raw2logit_tpu_torch.models.unetpp import UNetPlusPlus
from raw2logit_tpu_torch.ops.mosaic import pack_raw


class NNProcessing(nn.Module):
    """raw (B, H, W) -> (rgb (B, 3, H/2, W/2), stages ``demosaic``,
    ``rgb``). The normalisation comes before the ``demosaic`` stage here,
    unlike ``RawToRGB``. ``device`` None means cuda; the U-Net++'s
    random init draws from ``generator``. (JAX's ``encoder_name``,
    ``remat`` and ``batch_norm_output`` are constants here: its CLI
    builds a resnet34 encoder, no remat and the output batch norm.)"""

    def __init__(self, normalize_mosaic_mean=None, normalize_mosaic_std=None,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        register_mosaic_stats(self, normalize_mosaic_mean,
                              normalize_mosaic_std, device)
        self.model = UNetPlusPlus(encoder_name="resnet34", encoder_depth=3,
                                  decoder_channels=(256, 128, 64),
                                  in_channels=3, classes=3, device=device,
                                  generator=generator)
        self.batch_norm = TorchBatchNorm(3, device=device)

    def forward(self, raw, taps=None):
        """``taps`` maps stage names to tensors added at that stage (their
        gradients are the stages' gradients, ``tracking.images``)."""
        taps = taps or {}
        rgb = normalise_mosaic(self, pack_raw(raw, reduce_size=True,
                                              out_channels=3))
        if "demosaic" in taps:
            rgb = rgb + taps["demosaic"]
        stages = {"demosaic": rgb}
        rgb = self.batch_norm(self.model(rgb))
        if "rgb" in taps:
            rgb = rgb + taps["rgb"]
        stages["rgb"] = rgb
        return rgb, stages
