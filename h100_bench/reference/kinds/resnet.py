"""Model kind ``resnet``: the ResNet classifier of the port's
``models/resnet.py`` (a frozen copy of its plain float32 math), under the
port's state dict names, and its MACs from shapes.

A 7x7/2 conv padded 3, batch norm, ReLU, a 3x3/2 max pool padded 1, then
four stages of blocks whose convs pad as flax "SAME" (a stride-2 3x3 conv
on an even input pads (0, 1)); the first block of stages 2-4 strides 2.
A BasicBlock (resnet18, resnet34) is two 3x3 convs of the stage's width;
a Bottleneck (resnet50) is a 1x1, a 3x3 that carries the stride and a
1x1 that widens 4x. Every conv is followed by batch norm, with ReLU
between them; a 1x1 strided projection and batch norm take the residual
wherever its shape changes, and ReLU follows the sum. The head is the
mean over H and W and a linear layer. Batch norms normalise with the
batch's biased statistics in train mode and with the running statistics
in eval mode.

``model``: ``{"kind": "resnet", "arch": <a key of ARCHS>,
"num_classes": n}``. ``features`` is the features path that the U-Net++
kind's encoder runs.
"""

import torch.nn.functional as F

from h100_bench.reference.ops import (batch_norm, bn_spec, conv2d,
                                      conv_same, conv_spec, linear)

# arch: (block, blocks per stage), as the port's RESNET_CONFIGS
ARCHS = {"resnet18": ("basic", (2, 2, 2, 2)),
         "resnet34": ("basic", (3, 4, 6, 3)),
         "resnet50": ("bottleneck", (3, 4, 6, 3))}
EXPANSION = {"basic": 1, "bottleneck": 4}


def blocks(arch, depth=None):
    """Per stage, its blocks as (convs, projection): convs [(c_in, c_out,
    kernel, stride)], the n-th named ``conv<n>`` and followed by
    ``bn<n>``; the projection (c_in, c_out, stride) or None. ``depth``
    keeps the stages a features path of that depth runs."""
    block, counts = ARCHS[arch]
    if depth is not None:
        counts = counts[:max(depth - 1, 0)]
    wide = EXPANSION[block]
    c, stages = 64, []
    for i, n in enumerate(counts):
        f = 64 * 2 ** i
        stage = []
        for j in range(n):
            s = 2 if i > 0 and j == 0 else 1
            if block == "basic":
                convs = [(c, f, 3, s), (f, f, 3, 1)]
            else:
                convs = [(c, f, 1, 1), (f, f, 3, s), (f, wide * f, 1, 1)]
            stage.append((convs, (c, wide * f, s)
                          if s != 1 or c != wide * f else None))
            c = wide * f
        stages.append(stage)
    return stages


def resnet_spec(arch, num_classes=None, depth=None, prefix=""):
    """[(state dict name, shape, kind)] of a ResNet, in the port's order
    of ``state_dict()``; ``depth`` as in ``blocks``."""
    out = []
    conv_spec(out, f"{prefix}conv1", 64, 3, 7)
    bn_spec(out, f"{prefix}bn1", 64)
    c = 64
    for i, stage in enumerate(blocks(arch, depth)):
        for j, (convs, proj) in enumerate(stage):
            name = f"{prefix}layer{i + 1}.{j}"
            for n, (c_in, c_out, k, _) in enumerate(convs, start=1):
                conv_spec(out, f"{name}.conv{n}", c_out, c_in, k)
                bn_spec(out, f"{name}.bn{n}", c_out)
            if proj is not None:
                conv_spec(out, f"{name}.downsample.0", proj[1], proj[0], 1)
                bn_spec(out, f"{name}.downsample.1", proj[1])
            c = convs[-1][1]
    if num_classes is not None:
        out += [(f"{prefix}fc.weight", (num_classes, c), "linear"),
                (f"{prefix}fc.bias", (num_classes,), "bias")]
    return out


def features(p, x, arch, train, tf32, depth=None, prefix=""):
    """[stem's pre-pool plane, each stage's output] of the ResNet."""
    y = conv2d(x, p[f"{prefix}conv1.weight"], tf32, stride=2, padding=3)
    y = F.relu(batch_norm(p, f"{prefix}bn1", y, train))
    feats = [y]
    y = F.max_pool2d(y, 3, 2, padding=1)
    for i, stage in enumerate(blocks(arch, depth)):
        for j, (convs, proj) in enumerate(stage):
            name = f"{prefix}layer{i + 1}.{j}"
            h = y
            for n, (_, _, _, s) in enumerate(convs, start=1):
                h = batch_norm(p, f"{name}.bn{n}",
                               conv_same(p, f"{name}.conv{n}", h, s, tf32),
                               train)
                if n < len(convs):
                    h = F.relu(h)
            if proj is not None:
                y = batch_norm(p, f"{name}.downsample.1",
                               conv_same(p, f"{name}.downsample.0", y,
                                         proj[2], tf32), train)
            y = F.relu(h + y)
        feats.append(y)
    return feats


def layers(arch, height, width, num_classes=None, depth=None):
    """MACs per image of every conv and linear layer on a (3, height,
    width) input (the stem conv, each block's convs and projection, the
    ``fc`` head where ``num_classes`` is given), and the features'
    (channels, h, w) from the stem's pre-pool plane on."""
    h, w = (height + 6 - 7) // 2 + 1, (width + 6 - 7) // 2 + 1
    macs = [3 * 64 * 49 * h * w]
    feats = [(64, h, w)]
    h, w = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1  # 3x3/2 max pool
    c = 64
    for stage in blocks(arch, depth):
        for convs, proj in stage:
            for c_in, c_out, k, s in convs:
                h, w = -(-h // s), -(-w // s)  # flax SAME: ceil(n / s)
                macs.append(c_in * c_out * k * k * h * w)
            if proj is not None:
                macs.append(proj[0] * proj[1] * h * w)
            c = convs[-1][1]
        feats.append((c, h, w))
    if num_classes is not None:
        macs.append(c * num_classes)
    return macs, feats


def spec(model):
    return resnet_spec(model["arch"], num_classes=model["num_classes"])


def forward(model, p, x, train, tf32=False):
    """Logits (B, classes) of the ResNet classifier."""
    y = features(p, x, model["arch"], train, tf32)[-1]
    return linear(y.mean(dim=(2, 3)), p["fc.weight"], p["fc.bias"], tf32)


def macs(model, height, width):
    return sum(layers(model["arch"], height, width,
                      num_classes=model["num_classes"])[0])
