"""Model kind ``unetpp``: the U-Net++ of the port's ``models/unetpp.py``
(a frozen copy of its plain float32 math) on a ResNet encoder of the
``resnet`` kind, under the port's state dict names, and its MACs from
shapes.

The encoder's features (input, stem, stages; a stage is as wide as its
blocks' output, 4x its width for a Bottleneck) are row 0 of a nested grid
whose node x_i_j is (3x3 conv, BN, ReLU) x 2 over the concat of x_i_0 ..
x_i_{j-1} and the 2x nearest upsample of x_{i+1}_{j-1}, with
``decoder_channels[::-1][i]`` channels; a 3x3 conv with bias reads
x_0_depth. The encoder runs ``len(decoder_channels) - 1`` stages.

``model``: ``{"kind": "unetpp", "encoder": <a resnet arch>,
"decoder_channels": [...], "classes": n}``.
"""

import torch
import torch.nn.functional as F

from h100_bench.reference.kinds import resnet
from h100_bench.reference.ops import (batch_norm, bn_spec, conv2d,
                                      conv_spec)


def _grid(depth):
    """The decoder's nodes (i, j) in the port's order."""
    return [(i, j) for j in range(1, depth + 1) for i in range(depth + 1 - j)]


def _decoder_channels(encoder, decoder):
    """({(i, j): channels} of the grid's nodes and row 0, {(i, j): input
    channels} of its nodes)."""
    depth = len(decoder)
    ch = {(0, 0): 3, (1, 0): 64}
    for i, stage in enumerate(resnet.blocks(encoder, depth)):
        ch[i + 2, 0] = stage[-1][0][-1][1]
    rows = list(decoder)[::-1]
    n_in = {}
    for i, j in _grid(depth):
        n_in[i, j] = sum(ch[i, k] for k in range(j)) + ch[i + 1, j - 1]
        ch[i, j] = rows[i]
    return ch, n_in


def unetpp_spec(encoder, decoder, classes):
    """[(state dict name, shape, kind)] of the U-Net++."""
    out = resnet.resnet_spec(encoder, depth=len(decoder), prefix="encoder.")
    ch, n_in = _decoder_channels(encoder, decoder)
    for i, j in _grid(len(decoder)):
        name = f"x_{i}_{j}"
        conv_spec(out, f"{name}.conv0", ch[i, j], n_in[i, j], 3)
        bn_spec(out, f"{name}.bn0", ch[i, j])
        conv_spec(out, f"{name}.conv1", ch[i, j], ch[i, j], 3)
        bn_spec(out, f"{name}.bn1", ch[i, j])
    out += [("segmentation_head.weight", (classes, ch[0, 1], 3, 3), "conv"),
            ("segmentation_head.bias", (classes,), "bias")]
    return out


def _block(p, name, x, train, tf32):
    x = F.relu(batch_norm(p, f"{name}.bn0", conv2d(
        x, p[f"{name}.conv0.weight"], tf32, padding=1), train))
    return F.relu(batch_norm(p, f"{name}.bn1", conv2d(
        x, p[f"{name}.conv1.weight"], tf32, padding=1), train))


def unetpp_forward(p, x, encoder, decoder, train, tf32=False):
    """Logits (B, classes, H, W) of the U-Net++."""
    depth = len(decoder)
    feats = resnet.features(p, x, encoder, train, tf32, depth=depth,
                            prefix="encoder.")
    grid = {(0, 0): x}
    for i, f in enumerate(feats, start=1):
        grid[i, 0] = f
    for i, j in _grid(depth):
        up = F.interpolate(grid[i + 1, j - 1], scale_factor=2, mode="nearest")
        y = torch.cat([grid[i, k] for k in range(j)] + [up], dim=1)
        grid[i, j] = _block(p, f"x_{i}_{j}", y, train, tf32)
    out = conv2d(grid[0, depth], p["segmentation_head.weight"], tf32,
                 padding=1)
    return out + p["segmentation_head.bias"][None, :, None, None]


def unetpp_layers(encoder, height, width, decoder, classes):
    """MACs per image of every conv of the U-Net++: the encoder's, then
    the nested decoder's conv blocks, then the 3x3 head."""
    depth = len(decoder)
    macs, feats = resnet.layers(encoder, height, width, depth=depth)
    size = {0: (height, width)}
    for i, (_, h, w) in enumerate(feats, start=1):
        size[i] = (h, w)
    _, n_in = _decoder_channels(encoder, decoder)
    rows = list(decoder)[::-1]
    for i, j in _grid(depth):
        h, w = size[i]
        macs.append(n_in[i, j] * rows[i] * 9 * h * w)
        macs.append(rows[i] * rows[i] * 9 * h * w)
    macs.append(rows[0] * classes * 9 * height * width)
    return macs


def spec(model):
    return unetpp_spec(model["encoder"], tuple(model["decoder_channels"]),
                       model["classes"])


def forward(model, p, x, train, tf32=False):
    return unetpp_forward(p, x, model["encoder"],
                          tuple(model["decoder_channels"]), train, tf32)


def macs(model, height, width):
    return sum(unetpp_layers(model["encoder"], height, width,
                             tuple(model["decoder_channels"]),
                             model["classes"]))
