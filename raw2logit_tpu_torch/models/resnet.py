"""ResNet-18/34/50 classifiers (port of ``raw2logit_tpu/models/resnet.py``).

NCHW, torchvision parameter names (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer2.0.downsample.0``, ``fc``), and the JAX model's numerics, which
differ from torchvision's in three places:

  * the block convs pad as flax ``padding="SAME"``: a stride-2 3x3 conv
    on an even input pads (0, 1), not (1, 1);
  * the last batch norm of every block starts with a zero scale;
  * in train mode the batch norms update the running variance with the
    biased batch variance, as flax does (``FlaxBatchNorm2d``).

``ResNet(pool_two_stage=True)`` computes the plain stem's max pool as
JAX's two-stage decomposition (``stem_max_pool``), bitwise the same. The
classifier path runs the stem, conv1 + bn1 + ReLU + maxpool, through the
CUDA kernels of ``kernels/stem.py`` wherever they take the input (a
float32 (B, 3, H, W) on the card, H and W multiples of 4, a model of 64
filters on 3 channels), in train and in eval mode, forward and backward;
any other input, and the features path, runs the plain stem.
``stem_kernel=True`` (JAX ``stem_pallas``) forces the kernels,
``stem_kernel=False`` the plain stem. The parameter names are the same
either way, so state dicts load either way.

``dtype`` (JAX ``dtype``) is the compute dtype, float32 or bfloat16; the
parameters, running statistics and optimizer state stay float32 (flax's
``param_dtype``). In bfloat16 each layer rounds where its flax layer does
(not ``torch.autocast``, which keeps other ops in float32): a conv casts
its input and kernel to bfloat16 and returns bfloat16; a batch norm takes
its statistics and normalises in float32 from the bfloat16 input and
returns bfloat16; ReLU, the residual add and the max pool stay bfloat16;
the mean over H and W sums in float32 and rounds to bfloat16; the ``fc``
head computes in float32. The plain stem's batch norm takes its
statistics from the rounded conv output, the kernel stem from the float32
accumulator, as in JAX. ``load_pretrained_variables`` overlays ImageNet
weights converted to the JAX package's npz layout (flax paths), so one
file serves both packages.
"""

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.convert import resnet_name
from raw2logit_tpu_torch.kernels.stem import (check_stem_input, stem_eval,
                                              stem_train)
from raw2logit_tpu_torch.parallel import distributed


def cast(x, dtype):
    """``x`` in the compute ``dtype``: cast where that is bfloat16; float32
    computes in the input's own dtype (a float64 model stays float64)."""
    return x if dtype == torch.float32 else x.to(dtype)


class Conv2d(nn.Conv2d):
    """Bias-free conv computing in ``compute_dtype`` (flax ``nn.Conv(dtype=
    ...)``): in bfloat16 its input and its float32 kernel are cast to
    bfloat16 and it returns bfloat16."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, device=None, compute_dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=padding, bias=False, device=device)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt), None)


class Conv2dSame(Conv2d):
    """Bias-free conv with flax ``padding="SAME"``: output size
    ceil(n / stride), the padding computed per call from the input size
    and split with the extra pixel at the end."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 device=None, compute_dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         device=device, compute_dtype=compute_dtype)

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
    global batch's (``distributed.sync_batch_norm``). With a bfloat16
    ``compute_dtype`` (flax ``nn.BatchNorm(dtype=bfloat16)``) the input is
    widened, statistics and normalisation are float32 and the output is
    rounded to bfloat16."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return self._normalise(x)
        return self._normalise(x.float()).to(self.compute_dtype)

    def _normalise(self, x):
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


def _bn(features, device, dtype=torch.float32):
    return FlaxBatchNorm2d(features, eps=1e-5, momentum=0.1, device=device,
                           compute_dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_channels, filters, stride=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, filters, 3, stride, device, dtype)
        self.bn1 = _bn(filters, device, dtype)
        self.conv2 = Conv2dSame(filters, filters, 3, 1, device, dtype)
        self.bn2 = _bn(filters, device, dtype)
        self.downsample = _downsample(in_channels, filters, stride, device,
                                      dtype)

    def zero_init_last_bn(self):
        nn.init.zeros_(self.bn2.weight)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_channels, filters, stride=1, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = Conv2dSame(in_channels, filters, 1, 1, device, dtype)
        self.bn1 = _bn(filters, device, dtype)
        self.conv2 = Conv2dSame(filters, filters, 3, stride, device, dtype)
        self.bn2 = _bn(filters, device, dtype)
        self.conv3 = Conv2dSame(filters, filters * 4, 1, 1, device, dtype)
        self.bn3 = _bn(filters * 4, device, dtype)
        self.downsample = _downsample(in_channels, filters * 4, stride,
                                      device, dtype)

    def zero_init_last_bn(self):
        nn.init.zeros_(self.bn3.weight)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


def _downsample(in_channels, out_channels, stride, device, dtype):
    """1x1 strided projection where the residual's shape changes."""
    if stride == 1 and in_channels == out_channels:
        return None
    return nn.Sequential(
        Conv2dSame(in_channels, out_channels, 1, stride, device, dtype),
        _bn(out_channels, device, dtype))


RESNET_CONFIGS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def stem_max_pool(y, two_stage=False):
    """The stem's 3x3/2 max pool, padded (1, 1) with -inf, of NCHW ``y``.

    ``two_stage=True`` is JAX's exact decomposition (a TPU probe): a 2x2/1
    pool padded (1, 0), then a 2x2/2 pool. Per axis max(a[2i], a[2i+1])
    with a[j] = max(x[j-1], x[j]) covers x[2i-1..2i+1], the same taps, so
    the value is bitwise the same, and so is the gradient wherever a
    window's maximum is unique. As in JAX it applies to even H and W
    only (an odd one takes the 3x3 pool)."""
    if not two_stage or y.shape[2] % 2 or y.shape[3] % 2:
        return F.max_pool2d(y, 3, 2, padding=1)
    a = F.max_pool2d(F.pad(y, (1, 0, 1, 0), value=-math.inf), 2, 1)
    return F.max_pool2d(a, 2, 2)


def on_card(x):
    """Whether ``x`` is on the card, where the stem kernels launch (on the
    CPU they would run their plain versions). The one device test of the
    stem's routing."""
    return x.is_cuda


def stem_kernels_take(x, w):
    """Whether the fused stem kernels take input ``x`` and conv weight
    ``w`` on the card: ``kernels.stem.check_stem_input`` passes (a float32
    (B, 3, H, W), H and W multiples of 4, and a float32 (64, 3, 7, 7)
    weight on its device)."""
    if not on_card(x):
        return False
    try:
        check_stem_input(x, w)
    except (ValueError, NotImplementedError):
        return False
    return True


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

    ``stem_kernel``: which stem the classifier path (not
    ``return_features``, which needs the pre-pool plane and always runs
    the plain stem) takes. The fused kernels run ``StemTrain`` in train
    mode (bn1's running statistics updated as ``FlaxBatchNorm2d`` does)
    and ``stem_eval`` in eval mode, whose backward runs the same backward
    kernels with bn1's running statistics held constant; with ``dtype``
    bfloat16 they run their bfloat16 forms. ``None`` (the default)
    chooses by the input: the kernels where ``stem_kernels_take(x,
    conv1.weight)`` (on the card, a float32 (B, 3, H, W) with H, W
    multiples of 4, and a model of 64 filters on 3 input channels), else
    the plain stem, so that on the CPU the default is the plain stem.
    ``True`` forces the kernels (their plain versions on the CPU) and
    raises on a model or an input they cannot take; ``False`` forces the
    plain stem.

    ``dtype``: the compute dtype, float32 or bfloat16 (module docstring);
    parameters and statistics stay float32, the logits are float32.

    ``pool_two_stage``: the plain stem pools through ``stem_max_pool``'s
    two-stage form (JAX's flag; the same parameters and result).
    """

    def __init__(self, block_cls=BasicBlock, stage_sizes=(2, 2, 2, 2),
                 num_classes=2, num_filters=64, in_channels=3, device=None,
                 generator=None, stem_kernel=None, dtype=torch.float32,
                 pool_two_stage=False):
        super().__init__()
        if stem_kernel and (num_filters != 64 or in_channels != 3):
            raise NotImplementedError(
                f"stem_kernel needs 64 filters and 3 input channels (the "
                f"kernels hard-code them), got {num_filters} and "
                f"{in_channels}")
        if dtype not in (torch.float32, torch.bfloat16):
            raise NotImplementedError(f"the compute dtype is float32 or "
                                      f"bfloat16, got {dtype}")
        self.stem_kernel, self.dtype = stem_kernel, dtype
        self.pool_two_stage = pool_two_stage
        device = resolve_device(device)
        self.conv1 = Conv2d(in_channels, num_filters, 7, 2, padding=3,
                            device=device, compute_dtype=dtype)
        self.bn1 = _bn(num_filters, device, dtype)
        channels = num_filters
        self.layers = []
        for i, block_count in enumerate(stage_sizes):
            blocks = []
            for j in range(block_count):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(channels, num_filters * 2 ** i,
                                        stride, device, dtype))
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

    def runs_fused_stem(self, x, return_features=False):
        """Whether ``forward(x, return_features)`` runs the fused stem
        (``stem_kernel``)."""
        if return_features:
            return False
        if self.stem_kernel is not None:
            return bool(self.stem_kernel)
        return stem_kernels_take(x, self.conv1.weight)

    def _fused_stem(self, x):
        bn = self.bn1
        if not self.training:
            return stem_eval(x, self.conv1.weight, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var, bn.eps,
                             self.dtype)
        pooled, mean, var = stem_train(x, self.conv1.weight, bn.weight,
                                       bn.bias, bn.eps, self.dtype)
        bn.update_running(mean, var)
        return pooled

    def forward(self, x, return_features=False, depth=5):
        feats = [x]
        if self.runs_fused_stem(x, return_features):
            y = self._fused_stem(x)
        else:
            y = F.relu(self.bn1(self.conv1(x)))
            feats.append(y)  # 1/2
            y = stem_max_pool(y, self.pool_two_stage)
        layers = (self.layers[:max(depth - 1, 0)] if return_features
                  else self.layers)
        for layer in layers:
            y = layer(y)
            feats.append(y)  # 1/4, 1/8, 1/16, 1/32
        if return_features:
            return feats[:depth + 1]
        if self.dtype != torch.float32:  # jnp.mean of bfloat16
            return self.fc(y.float().mean(dim=(2, 3)).to(self.dtype).float())
        return self.fc(y.mean(dim=(2, 3)))


def _weights_path(model, weights_dir):
    return os.path.join(weights_dir, f"{model.lower()}.npz")


def resnet_model(model="resnet18", pretrained=False, in_channels=3,
                 fc_out_features=2, dtype=torch.float32, weights_dir="weights",
                 device=None, generator=None, stem_kernel=None):
    """Factory mirroring the JAX ``resnet_model``. ``pretrained`` requires
    converted ImageNet weights at ``<weights_dir>/<model>.npz`` (the JAX
    package's ``tools/convert_torchvision.py`` writes them on a host that
    has torchvision) and raises here, at build time, when the file is
    missing; the overlay itself is ``load_pretrained_variables``, which
    the CLI applies after building, as the JAX package does."""
    block_cls, stage_sizes = RESNET_CONFIGS[model.lower()]
    net = ResNet(block_cls=block_cls, stage_sizes=stage_sizes,
                 num_classes=fc_out_features, in_channels=in_channels,
                 device=device, generator=generator,
                 stem_kernel=stem_kernel, dtype=dtype)
    if pretrained:
        path = _weights_path(model, weights_dir)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"--classifier_pretrained requested but {path} does not "
                f"exist. Convert torchvision ImageNet weights with the JAX "
                f"package's `python tools/convert_torchvision.py "
                f"{model.lower()} {path}` on a host that has torchvision, "
                f"or from a torchvision-layout checkpoint with its "
                f"`--state_dict ckpt.pth` (needs only torch)")
    return net


# ---------------------------------------------------------------------------
# ImageNet weights (port of the JAX package's overlay,
# raw2logit_tpu/models/resnet.py:246-344)


def load_pretrained_npz(path):
    """A flat {flax path: array} npz of converted weights, e.g.
    ``params/layer1_0/Conv_0/kernel``, as numpy arrays."""
    with np.load(path) as data:
        return {k: np.asarray(v) for k, v in data.items()}


# conv_init and fc stay at random init: the reference replaces
# torchvision's conv1 and fc with freshly initialised layers even when
# pretrained (its model.py:15-23), so only the backbone carries ImageNet
# weights. Flax names, as the npz keys.
PRETRAINED_SKIP = ("conv_init", "fc")

# flax leaf -> the port's tensor: (collection, leaf) -> attribute
_LEAVES = {("params", "kernel"): "weight", ("params", "scale"): "weight",
           ("params", "bias"): "bias", ("batch_stats", "mean"):
           "running_mean", ("batch_stats", "var"): "running_var"}


def _to_torch_layout(leaf, arr):
    """A flax array in the port's layout: conv kernels HWIO -> OIHW, Dense
    kernels (in, out) -> (out, in); everything else as it is."""
    if leaf != "kernel":
        return arr
    return np.transpose(arr, (3, 2, 0, 1) if arr.ndim == 4 else (1, 0))


def _flax_shape(leaf, tensor):
    """The shape of the port's ``tensor`` in the flax layout."""
    shape = tuple(tensor.shape)
    if leaf != "kernel":
        return shape
    return (shape[2], shape[3], shape[1], shape[0]) if len(shape) == 4 \
        else shape[::-1]


def overlay_pretrained(module, flat, skip=PRETRAINED_SKIP, prefix=(),
                       ignore_missing=False):
    """Copy a flat ``{collection/module/.../leaf: array}`` dict (flax paths,
    the layout of the JAX package's ``tools/convert_torchvision.py``) into
    ``module``'s parameters and running statistics, in place, with the
    layout transposes of ``convert.py``; flax module names map to the
    port's by ``convert.resnet_name`` (``conv_init`` -> ``conv1``,
    ``layer1_0/Conv_0`` -> ``layer1.0.conv1``).

    ``prefix`` (flax names) descends into a submodule first, e.g.
    ``("encoder",)`` for the U-Net++ encoder. Keys whose first module is in
    ``skip`` are left out. Strict: unknown paths and shape mismatches
    raise, unless ``ignore_missing`` (a truncated encoder, such as the
    neural ISP's depth-3 resnet34, has only the early stages), which skips
    what the module lacks. Returns the list of applied keys."""
    applied = []
    with torch.no_grad():
        for key, arr in flat.items():
            coll, *path = key.split("/")
            if path and path[0] in skip:
                continue
            if coll not in ("params", "batch_stats"):
                raise KeyError(f"collection {coll!r} not in variables "
                               f"(have ['batch_stats', 'params'])")
            name = resnet_name(tuple(prefix) + tuple(path[:-1]))
            try:
                target = module.get_submodule(name)
            except AttributeError:
                if ignore_missing:
                    continue
                raise KeyError(f"pretrained path {key!r} not found under "
                               f"prefix {tuple(prefix)}: no module "
                               f"{name!r}") from None
            attr = _LEAVES.get((coll, path[-1]))
            tensor = getattr(target, attr, None) if attr else None
            if not torch.is_tensor(tensor):
                if ignore_missing:
                    continue
                raise KeyError(f"pretrained leaf {key!r} not in variables")
            arr = np.asarray(arr)
            if _flax_shape(path[-1], tensor) != arr.shape:
                raise ValueError(f"shape mismatch for {key}: variables have "
                                 f"{_flax_shape(path[-1], tensor)}, npz has "
                                 f"{arr.shape}")
            value = _to_torch_layout(path[-1], arr)
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(
                value, dtype=np.float32)))
            applied.append(key)
    return applied


def load_pretrained_variables(model_name, module, weights_dir="weights",
                              prefix=(), required=True, ignore_missing=False):
    """Overlay the converted ImageNet weights of ``model_name`` from
    ``<weights_dir>/<model_name>.npz`` onto ``module`` in place; returns
    the applied keys.

    ``required`` raises when the file is missing (the user asked for
    pretrained weights); otherwise the module is left as it is, with a
    note (the segmentation encoder's default, best-effort). The
    ``conv_init`` and ``fc`` skip applies only to the top-level classifier
    (``prefix=()``); an encoder under a prefix loads its full stem and
    skips only ``fc``."""
    path = _weights_path(model_name, weights_dir)
    if not os.path.exists(path):
        if required:
            raise FileNotFoundError(
                f"pretrained weights requested but {path} does not exist; "
                f"convert them with the JAX package's "
                f"tools/convert_torchvision.py on a host with torchvision, "
                f"or from a torchvision-layout checkpoint with its "
                f"--state_dict mode")
        print(f"note: no converted ImageNet weights at {path}; "
              f"encoder uses random init")
        return []
    skip = PRETRAINED_SKIP if not prefix else ("fc",)
    return overlay_pretrained(module, load_pretrained_npz(path), skip=skip,
                              prefix=prefix, ignore_missing=ignore_missing)
