"""The task models in plain PyTorch over dicts of tensors (a frozen copy
of the port's ``models/resnet.py`` and ``models/unetpp.py`` in float32),
under the port's state dict names.

ResNet (BasicBlock): a 7x7/2 conv padded 3, batch norm, ReLU, a 3x3/2 max
pool padded 1, then stages of blocks whose 3x3 convs pad as flax "SAME"
(a stride-2 conv on an even input pads (0, 1)), each block's projection
a 1x1 strided conv and batch norm; the head is the mean over H and W and
a linear layer. U-Net++: the ResNet's features (input, stem, stages) as
row 0 of a nested grid whose node x_i_j is (3x3 conv, BN, ReLU) x 2 over
the concat of x_i_0 .. x_i_{j-1} and the 2x nearest upsample of
x_{i+1}_{j-1}; a 3x3 conv with bias reads x_0_depth. Batch norms
normalise with the batch's biased statistics in train mode and with the
running statistics in eval mode (eps 1e-5).
"""

import torch
import torch.nn.functional as F

from h100_bench.reference.ops import conv2d, linear

STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}
BN_EPS = 1e-5


def _conv_spec(out, name, c_out, c_in, k):
    out.append((f"{name}.weight", (c_out, c_in, k, k), "conv"))


def _bn_spec(out, name, c):
    out += [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "running_mean"),
            (f"{name}.running_var", (c,), "running_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def resnet_spec(arch, num_classes=None, depth=None, prefix=""):
    """[(state dict name, shape, kind)] of a ResNet, in the port's order
    of ``state_dict()``; ``depth`` keeps the stages a features path of
    that depth runs (the U-Net++ encoder)."""
    out = []
    _conv_spec(out, f"{prefix}conv1", 64, 3, 7)
    _bn_spec(out, f"{prefix}bn1", 64)
    stages = STAGES[arch]
    if depth is not None:
        stages = stages[:max(depth - 1, 0)]
    c = 64
    for i, blocks in enumerate(stages):
        f = 64 * 2 ** i
        for j in range(blocks):
            s = 2 if i > 0 and j == 0 else 1
            name = f"{prefix}layer{i + 1}.{j}"
            _conv_spec(out, f"{name}.conv1", f, c, 3)
            _bn_spec(out, f"{name}.bn1", f)
            _conv_spec(out, f"{name}.conv2", f, f, 3)
            _bn_spec(out, f"{name}.bn2", f)
            if s != 1 or c != f:
                _conv_spec(out, f"{name}.downsample.0", f, c, 1)
                _bn_spec(out, f"{name}.downsample.1", f)
            c = f
    if num_classes is not None:
        out += [(f"{prefix}fc.weight", (num_classes, c), "linear"),
                (f"{prefix}fc.bias", (num_classes,), "bias")]
    return out


def _grid(depth):
    """The decoder's nodes (i, j) in the port's order."""
    return [(i, j) for j in range(1, depth + 1) for i in range(depth + 1 - j)]


def _decoder_channels(encoder, decoder):
    """{(i, j): channels} of the U-Net++ grid's nodes and row 0."""
    depth = len(decoder)
    stages = STAGES[encoder][:depth - 1]
    ch = {(0, 0): 3, (1, 0): 64}
    for i in range(len(stages)):
        ch[i + 2, 0] = 64 * 2 ** i
    rows = list(decoder)[::-1]
    n_in = {}
    for i, j in _grid(depth):
        n_in[i, j] = sum(ch[i, k] for k in range(j)) + ch[i + 1, j - 1]
        ch[i, j] = rows[i]
    return ch, n_in


def unetpp_spec(encoder, decoder, classes):
    """[(state dict name, shape, kind)] of the U-Net++."""
    out = resnet_spec(encoder, depth=len(decoder), prefix="encoder.")
    ch, n_in = _decoder_channels(encoder, decoder)
    for i, j in _grid(len(decoder)):
        name = f"x_{i}_{j}"
        _conv_spec(out, f"{name}.conv0", ch[i, j], n_in[i, j], 3)
        _bn_spec(out, f"{name}.bn0", ch[i, j])
        _conv_spec(out, f"{name}.conv1", ch[i, j], ch[i, j], 3)
        _bn_spec(out, f"{name}.bn1", ch[i, j])
    out += [("segmentation_head.weight", (classes, ch[0, 1], 3, 3), "conv"),
            ("segmentation_head.bias", (classes,), "bias")]
    return out


def model_spec(model):
    """The spec of a configuration's ``model`` entry."""
    if model["kind"] == "resnet":
        return resnet_spec(model["arch"], num_classes=model["num_classes"])
    return unetpp_spec(model["encoder"], tuple(model["decoder_channels"]),
                       model["classes"])


def _bn(p, name, x, train):
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], True, 0.0, BN_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], False, 0.0, BN_EPS)


def _same_pad(x, k, s):
    """flax SAME padding of NCHW ``x`` for a k x k conv of stride s."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv_same(p, name, x, s, tf32):
    w = p[f"{name}.weight"]
    return conv2d(_same_pad(x, w.shape[-1], s), w, tf32, stride=s)


def resnet_features(p, x, arch, train, tf32, depth=None, prefix=""):
    """[stem's pre-pool plane, each stage's output] of the ResNet."""
    y = conv2d(x, p[f"{prefix}conv1.weight"], tf32, stride=2, padding=3)
    y = F.relu(_bn(p, f"{prefix}bn1", y, train))
    feats = [y]
    y = F.max_pool2d(y, 3, 2, padding=1)
    stages = STAGES[arch]
    if depth is not None:
        stages = stages[:max(depth - 1, 0)]
    for i, blocks in enumerate(stages):
        for j in range(blocks):
            s = 2 if i > 0 and j == 0 else 1
            name = f"{prefix}layer{i + 1}.{j}"
            h = F.relu(_bn(p, f"{name}.bn1",
                           _conv_same(p, f"{name}.conv1", y, s, tf32), train))
            h = _bn(p, f"{name}.bn2", _conv_same(p, f"{name}.conv2", h, 1,
                                                 tf32), train)
            if f"{name}.downsample.0.weight" in p:
                y = _bn(p, f"{name}.downsample.1",
                        _conv_same(p, f"{name}.downsample.0", y, s, tf32),
                        train)
            y = F.relu(h + y)
        feats.append(y)
    return feats


def resnet_forward(p, x, arch, train, tf32=False):
    """Logits (B, classes) of the ResNet classifier."""
    y = resnet_features(p, x, arch, train, tf32)[-1]
    return linear(y.mean(dim=(2, 3)), p["fc.weight"], p["fc.bias"], tf32)


def _block(p, name, x, train, tf32):
    x = F.relu(_bn(p, f"{name}.bn0", conv2d(x, p[f"{name}.conv0.weight"],
                                            tf32, padding=1), train))
    return F.relu(_bn(p, f"{name}.bn1", conv2d(x, p[f"{name}.conv1.weight"],
                                               tf32, padding=1), train))


def unetpp_forward(p, x, encoder, decoder, train, tf32=False):
    """Logits (B, classes, H, W) of the U-Net++."""
    depth = len(decoder)
    feats = resnet_features(p, x, encoder, train, tf32, depth=depth,
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


def model_forward(model, p, x, train, tf32=False):
    """The configuration's task model on ``x``."""
    if model["kind"] == "resnet":
        return resnet_forward(p, x, model["arch"], train, tf32)
    return unetpp_forward(p, x, model["encoder"],
                          tuple(model["decoder_channels"]), train, tf32)
