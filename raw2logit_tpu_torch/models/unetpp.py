"""U-Net++ (nested U-Net) with a ResNet encoder (port of
``raw2logit_tpu/models/unetpp.py``), NCHW.

Used as the segmentation task model (resnet encoder, depth 5, decoder
(256, 128, 64, 32, 16), one class) and inside the neural ISP (resnet34,
depth 3, decoder (256, 128, 64), 3 -> 3 channels).

A dense grid of nodes x_i_j: x_i_0 are the encoder's features at scale
1 / 2^i (row 0 is the input); x_i_j for j >= 1 is a conv block over the
channel concat of x_i_0 .. x_i_{j-1} and the 2x-upsampled x_{i+1}_{j-1},
in that order, with ``decoder_channels[::-1][i]`` channels. The head, a
3x3 convolution with bias, reads x_0_depth.

Every convolution here is 3x3 stride 1, so flax ``SAME`` is a pad of 1 on
each side. The decoder's batch norms are ``FlaxBatchNorm2d`` (momentum
0.9 in flax's terms, the biased running-variance update).

``dtype`` (JAX ``dtype``): in bfloat16 the encoder and the conv blocks
compute as the bfloat16 ``ResNet`` does (``models/resnet.py``), the
concatenations promote as in JAX (the float32 input row with bfloat16
features gives float32, which the next conv rounds), and the
segmentation head computes in float32; parameters stay float32.
"""

import contextlib

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.models.resnet import (RESNET_CONFIGS, Conv2d,
                                               ResNet, _bn, _lecun_normal_)


@contextlib.contextmanager
def _keeping_buffers(module):
    """Within: whatever runs, ``module``'s buffers come out as they went
    in (``torch.utils.checkpoint``'s recomputation of a forward that has
    already updated the batch norms' running statistics; the train-mode
    output reads the batch's statistics, not these)."""
    kept = [b.clone() for b in module.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, k in zip(module.buffers(), kept):
                b.copy_(k)


def _upsample2x(x):
    """Nearest-neighbour 2x upsample of (B, C, H, W): each pixel repeated
    into a 2x2 block."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ConvBlock(nn.Module):
    """(conv 3x3 -> BN -> ReLU) x 2, bias-free convs (flax ``ConvBlock``:
    ``conv0``, ``bn0``, ``conv1``, ``bn1``)."""

    def __init__(self, in_channels, filters, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv0 = Conv2d(in_channels, filters, 3, padding=1, device=device,
                            compute_dtype=dtype)
        self.bn0 = _bn(filters, device, dtype)
        self.conv1 = Conv2d(filters, filters, 3, padding=1, device=device,
                            compute_dtype=dtype)
        self.bn1 = _bn(filters, device, dtype)

    def forward(self, x):
        x = F.relu(self.bn0(self.conv0(x)))
        return F.relu(self.bn1(self.conv1(x)))


class UNetPlusPlus(nn.Module):
    """U-Net++ on NCHW input -> (B, classes, H, W) logits.

    The encoder is the port's ``ResNet`` with only the stages that
    ``encoder_depth`` runs and no ``fc``, as flax creates only what the
    features path touches. ``remat=True`` recomputes each decoder node's
    internals in the backward (``torch.utils.checkpoint``) instead of
    keeping them; the recomputation leaves the running statistics alone,
    so outputs, gradients and statistics are bitwise those of
    ``remat=False``. ``device`` None means cuda (raises when CUDA is
    missing); the random init (flax's: lecun-normal convs, zero head
    bias) draws from ``generator``, seeded 0 when None. ``dtype``: the
    compute dtype, float32 or bfloat16 (module docstring); the logits are
    float32.
    """

    def __init__(self, encoder_name="resnet34", encoder_depth=5,
                 decoder_channels=(256, 128, 64, 32, 16), in_channels=3,
                 classes=1, remat=False, device=None, generator=None,
                 dtype=torch.float32):
        super().__init__()
        if len(decoder_channels) != encoder_depth:
            raise ValueError(f"{len(decoder_channels)} decoder channels for "
                             f"encoder depth {encoder_depth}")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.depth, self.remat, self.dtype = encoder_depth, remat, dtype
        block_cls, stage_sizes = RESNET_CONFIGS[encoder_name.lower()]
        stages = stage_sizes[:max(encoder_depth - 1, 0)]
        self.encoder = ResNet(block_cls=block_cls, stage_sizes=stages,
                              num_classes=None, in_channels=in_channels,
                              device=device, generator=generator, dtype=dtype)
        # channels of x_i_0: the input, the stem, the stages' outputs
        channels = {(0, 0): in_channels, (1, 0): 64}
        for i in range(len(stages)):
            channels[i + 2, 0] = 64 * 2 ** i * block_cls.expansion
        row_channels = list(decoder_channels)[::-1]
        d = encoder_depth
        for j in range(1, d + 1):
            for i in range(d + 1 - j):
                n_in = (sum(channels[i, k] for k in range(j))
                        + channels[i + 1, j - 1])
                channels[i, j] = row_channels[i]
                self.add_module(f"x_{i}_{j}",
                                ConvBlock(n_in, row_channels[i], device,
                                          dtype))
        self.segmentation_head = nn.Conv2d(row_channels[0], classes, 3,
                                           padding=1, device=device)
        self._init_decoder(generator)

    @torch.no_grad()
    def _init_decoder(self, generator):
        for name, m in self.named_modules():
            if name.startswith("encoder"):
                continue
            if isinstance(m, nn.Conv2d):
                _lecun_normal_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        nn.init.zeros_(self.segmentation_head.bias)

    def _node(self, block, x):
        if not (self.remat and torch.is_grad_enabled()):
            return block(x)
        return checkpoint(block, x, use_reentrant=False, context_fn=lambda: (
            contextlib.nullcontext(), _keeping_buffers(block)))

    def forward(self, x):
        d = self.depth
        feats = self.encoder(x, return_features=True, depth=d)
        grid = {(i, 0): f for i, f in enumerate(feats)}
        for j in range(1, d + 1):
            for i in range(d + 1 - j):
                y = torch.cat([grid[i, k] for k in range(j)]
                              + [_upsample2x(grid[i + 1, j - 1])], dim=1)
                grid[i, j] = self._node(getattr(self, f"x_{i}_{j}"), y)
        out = grid[0, d]
        if self.dtype != torch.float32:  # the head computes in float32
            out = out.float()
        return self.segmentation_head(out)
