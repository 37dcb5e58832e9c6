"""ResNet-18/34/50 classifiers (port of ``raw2logit_tpu/models/resnet.py``).

NCHW, torchvision parameter names (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer2.0.downsample.0``, ``fc``), and the JAX model's numerics, which
differ from torchvision's in three places:

  * the block convs pad as flax ``padding="SAME"``: a stride-2 3x3 conv
    on an even input pads (0, 1), not (1, 1);
  * the last batch norm of every block starts with a zero scale;
  * in train mode the batch norms update the running variance with the
    biased batch variance, as flax does (``FlaxBatchNorm2d``).

``ResNet(stem_kernel=True)`` (JAX ``stem_pallas``) runs the stem, conv1 +
bn1 + ReLU + maxpool, through the CUDA kernels of ``kernels/stem.py``. It
keeps the parameter names, so state dicts load either way.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.kernels.stem import stem_eval, stem_train
from raw2logit_tpu_torch.parallel import distributed


class Conv2dSame(nn.Conv2d):
    """Bias-free conv with flax ``padding="SAME"``: output size
    ceil(n / stride), the padding computed per call from the input size
    and split with the extra pixel at the end."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=0, bias=False, device=device)

    def forward(self, x):
        pads = []
        # F.pad takes the last dim first: (W lo, W hi, H lo, H hi)
        for n, k, s in ((x.shape[-1], self.kernel_size[1], self.stride[1]),
                        (x.shape[-2], self.kernel_size[0], self.stride[0])):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads) if any(pads) else x)


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax ``nn.BatchNorm``'s running-variance
    update: torch momentum 0.1 is flax's momentum 0.9
    (r = 0.9 r + 0.1 batch), and flax updates the running variance with
    the BIASED batch variance, where torch uses the unbiased one.
    Normalisation (biased batch variance in train mode, running
    statistics in eval mode) is torch's, which is flax's. Under a process
    group (``distributed.active()``) the train-mode statistics are the
    global batch's (``distributed.sync_batch_norm``)."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if distributed.active():
            y, mean, var, _ = distributed.sync_batch_norm(
                x, self.weight, self.bias, self.eps)
            self.update_running(mean, var)
            return y
        # with momentum 1 torch's op writes the batch mean and the
        # unbiased batch variance into the tensors it is given
        n = x.numel() // x.shape[1]
        mean = torch.zeros_like(self.running_mean)
        var = torch.ones_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        self.update_running(mean, var * ((n - 1) / n))
        return y

    @torch.no_grad()
    def update_running(self, mean, biased_var):
        """flax's update of the running statistics from a batch's mean and
        biased variance: r <- (1 - m) r + m batch, m the torch momentum;
        counts the batch."""
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(biased_var, alpha=m)
        self.num_batches_tracked.add_(1)


def _bn(features, device):
    return FlaxBatchNorm2d(features, eps=1e-5, momentum=0.1, device=device)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels, filters, stride=1, device=None):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, filters, 3, stride, device)
        self.bn1 = _bn(filters, device)
        self.conv2 = Conv2dSame(filters, filters, 3, 1, device)
        self.bn2 = _bn(filters, device)
        self.downsample = _downsample(in_channels, filters, stride, device)

    def zero_init_last_bn(self):
        nn.init.zeros_(self.bn2.weight)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels, filters, stride=1, device=None):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, filters, 1, 1, device)
        self.bn1 = _bn(filters, device)
        self.conv2 = Conv2dSame(filters, filters, 3, stride, device)
        self.bn2 = _bn(filters, device)
        self.conv3 = Conv2dSame(filters, filters * 4, 1, 1, device)
        self.bn3 = _bn(filters * 4, device)
        self.downsample = _downsample(in_channels, filters * 4, stride,
                                      device)

    def zero_init_last_bn(self):
        nn.init.zeros_(self.bn3.weight)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _downsample(in_channels, out_channels, stride, device):
    """1x1 strided projection where the residual's shape changes."""
    if stride == 1 and in_channels == out_channels:
        return None
    return nn.Sequential(
        Conv2dSame(in_channels, out_channels, 1, stride, device),
        _bn(out_channels, device))


RESNET_CONFIGS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def _lecun_normal_(weight, generator):
    """flax's lecun_normal: truncated normal (+-2 sd) with variance
    1 / fan_in after truncation."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class ResNet(nn.Module):
    """ResNet backbone + linear head on NCHW input.

    forward(x) -> logits; forward(x, return_features=True, depth=d) ->
    [identity, stem (1/2), c2 (1/4), c3 (1/8), c4 (1/16), c5 (1/32)][:d + 1].
    ``num_classes=None`` builds no ``fc`` (a features-only encoder).
    ``device`` None means cuda (raises when CUDA is missing); the random
    init draws from ``generator`` (a ``torch.Generator`` on that device,
    seeded 0 when None). On the meta device it is left uninitialised,
    for a state dict to be assigned to it (``load_state_dict(...,
    assign=True)``).

    ``stem_kernel``: the classifier path (not ``return_features``, which
    needs the pre-pool plane) runs the stem through the fused kernels,
    ``StemTrain`` in train mode (bn1's running statistics updated as
    ``FlaxBatchNorm2d`` does) and ``stem_eval`` in eval mode, whose
    backward raises. It needs 64 filters, 3 input channels, float32 and
    H, W multiples of 4, and raises otherwise.
    """

    def __init__(self, block_cls=BasicBlock, stage_sizes=(2, 2, 2, 2),
                 num_classes=2, num_filters=64, in_channels=3, device=None,
                 generator=None, stem_kernel=False):
        super().__init__()
        if stem_kernel and (num_filters != 64 or in_channels != 3):
            raise NotImplementedError(
                f"stem_kernel needs 64 filters and 3 input channels (the "
                f"kernels hard-code them), got {num_filters} and "
                f"{in_channels}")
        self.stem_kernel = stem_kernel
        device = resolve_device(device)
        self.conv1 = nn.Conv2d(in_channels, num_filters, 7, 2, padding=3,
                               bias=False, device=device)
        self.bn1 = _bn(num_filters, device)
        channels = num_filters
        self.layers = []
        for i, block_count in enumerate(stage_sizes):
            blocks = []
            for j in range(block_count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(channels, num_filters * 2 ** i,
                                        stride, device))
                channels = num_filters * 2 ** i * block_cls.expansion
            layer = nn.Sequential(*blocks)
            self.add_module(f"layer{i + 1}", layer)
            self.layers.append(layer)
        self.fc = (None if num_classes is None
                   else nn.Linear(channels, num_classes, device=device))
        if device.type == "meta":  # no data to initialise: a state dict
            return                 # is assigned to it
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """flax's init: lecun-normal conv and fc weights, zero fc bias, unit
        BN scales except a zero scale on each block's last BN, running
        statistics 0 and 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                _lecun_normal_(m.weight, generator)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        if self.fc is not None:
            nn.init.zeros_(self.fc.bias)
        for layer in self.layers:
            for block in layer:
                block.zero_init_last_bn()

    def _fused_stem(self, x):
        bn = self.bn1
        if not self.training:
            return stem_eval(x, self.conv1.weight, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, bn.eps)
        pooled, mean, var = stem_train(x, self.conv1.weight, bn.weight,
                                       bn.bias, bn.eps)
        bn.update_running(mean, var)
        return pooled

    def forward(self, x, return_features=False, depth=5):
        feats = [x]
        if self.stem_kernel and not return_features:
            y = self._fused_stem(x)
        else:
            y = F.relu(self.bn1(self.conv1(x)))
            feats.append(y)  # 1/2
            # 3x3/2 maxpool, pad (1, 1) of -inf
            y = F.max_pool2d(y, 3, 2, padding=1)
        layers = (self.layers[:max(depth - 1, 0)] if return_features
                  else self.layers)
        for layer in layers:
            y = layer(y)
            feats.append(y)  # 1/4, 1/8, 1/16, 1/32
        if return_features:
            return feats[:depth + 1]
        return self.fc(y.mean(dim=(2, 3)))


def resnet_model(model="resnet18", in_channels=3, fc_out_features=2,
                 device=None, generator=None, stem_kernel=False):
    """Factory mirroring the JAX ``resnet_model`` (random init only)."""
    block_cls, stage_sizes = RESNET_CONFIGS[model.lower()]
    return ResNet(block_cls=block_cls, stage_sizes=stage_sizes,
                  num_classes=fc_out_features, in_channels=in_channels,
                  device=device, generator=generator,
                  stem_kernel=stem_kernel)
