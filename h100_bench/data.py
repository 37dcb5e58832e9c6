"""Inputs and weights made from the seed, on the device, in a few large
calls: the same seed gives the same mosaics, labels, masks, weights and
epoch orders; every seed gives the same sizes.

The mosaics follow the pattern of the port's synthetic datasets
(``SyntheticRawClassification`` and ``SyntheticRawSegmentation``; this is
a frozen copy of the pattern, drawn in bulk, not an import): a uniform
base in [0.1, 0.8] and, for classification, a Gaussian blob of radius
0.15 H whose amplitude runs from -0.18 to +0.18 with the class; for
segmentation an ellipse (centre in [0.25, 0.75], radii in [0.08, 0.2] of
the size) raised by 0.25, which is the mask; clipped to [0, 1].
"""

import math

import torch

# generator streams of one seed
WEIGHTS, POOL, ORDER = 0, 1, 2


def generator(seed, stream, device):
    """The ``torch.Generator`` of ``stream`` for ``seed`` on ``device``."""
    return torch.Generator(device).manual_seed((seed * 4 + stream) % 2 ** 64)


def _grid(n, size, lo, hi, g, device):
    """(n, 1, 1) centres (y, x) drawn in [lo, hi) of ``size``, and the
    pixel grid."""
    c = torch.rand(n, 2, generator=g, device=device) * (hi - lo) + lo
    yy = torch.arange(size, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(size, device=device, dtype=torch.float32)[None, :]
    return c[:, 0, None, None] * size, c[:, 1, None, None] * size, yy, xx


def classification_pool(n, size, classes, seed, device):
    """(mosaics (n, size, size) float32, labels (n,) int64)."""
    g = generator(seed, POOL, device)
    base = torch.rand(n, size, size, generator=g, device=device) * 0.7 + 0.1
    cy, cx, yy, xx = _grid(n, size, 0.3, 0.7, g, device)
    labels = torch.arange(n, device=device) % classes
    amp = 0.36 * (labels.float() / max(classes - 1, 1) - 0.5)
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (0.15 * size) ** 2
    raw = base.add_(amp[:, None, None] * torch.exp(-r2)).clamp_(0.0, 1.0)
    return raw, labels


def segmentation_pool(n, size, seed, device):
    """(mosaics (n, size, size), masks (n, size, size)), both float32."""
    g = generator(seed, POOL, device)
    base = torch.rand(n, size, size, generator=g, device=device) * 0.7 + 0.1
    cy, cx, yy, xx = _grid(n, size, 0.25, 0.75, g, device)
    radii = torch.rand(n, 2, generator=g, device=device) * 0.12 + 0.08
    ry = radii[:, 0, None, None] * size
    rx = radii[:, 1, None, None] * size
    mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0).float()
    raw = base.add_(0.25 * mask).clamp_(0.0, 1.0)
    return raw, mask


def pool(config, traffic, seed, device):
    """The cell's pool of mosaics and targets."""
    n, size = traffic["pool"], config["image_size"]
    if config["task"] == "classification":
        return classification_pool(n, size, config["model"]["num_classes"],
                                   seed, device)
    return segmentation_pool(n, size, seed, device)


def weights(spec, seed, device):
    """{name: tensor} for a spec [(name, shape, kind)]: conv and linear
    weights normal with variance 1 / fan_in (clamped at 2 sd, scaled back
    to that variance), batch-norm scales in [0.5, 1.5], batch-norm shifts
    0.1 sd, biases 0.01 sd, running statistics 0 and 1, counts 0. Drawn
    as one normal vector, sliced in the spec's order."""
    sizes = [math.prod(shape) for _, shape, _ in spec]
    g = generator(seed, WEIGHTS, device)
    flat = torch.randn(sum(sizes), generator=g, device=device).clamp_(-2, 2)
    out, offset = {}, 0
    for (name, shape, kind), size in zip(spec, sizes):
        z = flat[offset:offset + size].reshape(shape)
        offset += size
        if kind in ("conv", "linear"):
            fan_in = math.prod(shape[1:])
            out[name] = z * (math.sqrt(1.0 / fan_in) / 0.8796256610342398)
        elif kind == "bn_weight":
            out[name] = 1.0 + 0.25 * z
        elif kind == "bn_bias":
            out[name] = 0.1 * z
        elif kind == "bias":
            out[name] = 0.01 * z
        elif kind == "running_mean":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "running_var":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
    return out


def cast(tensors, dtype):
    """{name: tensor} with the floating-point tensors in ``dtype``."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tensors.items()}


class EpochFeed:
    """Batches of ``batch`` rows of a device-resident pool, walked in a
    seeded order: each epoch a fresh permutation of the pool, its ragged
    tail dropped. ``next()`` gathers on the device and never waits for
    it. ``kept`` holds the rows of the first ``keep`` batches."""

    def __init__(self, tensors, batch, seed, device, keep=0):
        self.tensors, self.batch, self.device = tensors, batch, device
        self.n = len(tensors[0])
        if self.n < batch:
            raise ValueError(f"a pool of {self.n} holds no batch of {batch}")
        self.g = generator(seed, ORDER, device)
        self.order, self.pos = None, 0
        self.per_epoch = self.n // batch
        self.keep, self.kept = keep, []

    def next(self):
        if self.order is None or self.pos == self.per_epoch:
            perm = torch.randperm(self.n, generator=self.g, device=self.device)
            self.order = perm[:self.per_epoch * self.batch].view(
                self.per_epoch, self.batch)
            self.pos = 0
        idx = self.order[self.pos]
        self.pos += 1
        if len(self.kept) < self.keep:
            self.kept.append(idx)
        return [t.index_select(0, idx) for t in self.tensors]
