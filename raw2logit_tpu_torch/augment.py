"""Batched augmentations with explicit draws, replayed on masks (port of
``raw2logit_tpu/augment.py``).

An augmentation draws its random numbers once per batch from a
``torch.Generator`` (``draw``) and applies them (``apply``): the same
draws applied to a segmentation mask replay the image's geometric
transforms, and the photometric ones (noise, sharpness) are skipped for
masks, as the reference's ``(transform, apply_for_mask=False)`` tuples
do. Tests hand both packages the same draws.

Layout: planar (B, C, H, W) images or (B, H, W) masks; H is dim -2 and W
dim -1. The scalar draws come from the generator on the host; the noise
plane is drawn on the images' device from a seed taken from it.
"""

import math

import torch
import torch.nn.functional as F

from raw2logit_tpu_torch.ops.filters import conv2d_f32


def _coin(generator):
    return bool(torch.rand((), generator=generator) < 0.5)


def hflip(x):
    return torch.flip(x, dims=(-1,))


def vflip(x):
    return torch.flip(x, dims=(-2,))


def rot90(x, k):
    """Turn in the (W, H) plane: ``jnp.rot90(v, k, axes=(2, 1))`` on the
    JAX package's NHWC, ``x.rot90(k, dims=(-1, -2))`` on NCHW in the
    reference."""
    return torch.rot90(x, int(k), dims=(-1, -2))


def _round_half_away(v):
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


def rotate(x, angle_deg):
    """Rotate every image of the batch by ``angle_deg`` about its centre,
    nearest neighbour with zero fill (torchvision RandomRotation's
    default): the inverse map of the JAX package's ``_rotate`` in
    float32, coordinates rounded half away from zero, source positions
    outside the image read 0."""
    h, w = x.shape[-2:]
    dev = x.device
    theta = torch.as_tensor(-angle_deg, dtype=torch.float32,
                            device=dev) * math.pi / 180.0
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    yc, xc = yy - (h - 1) / 2.0, xx - (w - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    src_y = _round_half_away(cos * yc - sin * xc + (h - 1) / 2.0).long()
    src_x = _round_half_away(sin * yc + cos * xc + (w - 1) / 2.0).long()
    valid = (src_y >= 0) & (src_y < h) & (src_x >= 0) & (src_x < w)
    flat = (src_y.clamp(0, h - 1) * w + src_x.clamp(0, w - 1)).reshape(-1)
    out = x.reshape(*x.shape[:-2], h * w)[..., flat].reshape(x.shape)
    return out * valid.to(x.dtype)


def add_gaussian_noise(x, noise, std=0.0005):
    return x + noise * std


def adjust_sharpness(x, factor=0.5):
    """torchvision RandomAdjustSharpness: blend the image with a fixed blur
    ([[1, 1, 1], [1, 5, 1], [1, 1, 1]] / 13, zero 'same' padding, border
    pixels kept from the original), then clamp to [0, 1]."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[:, None]
    c = x.shape[1]
    k = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0], [1.0, 1.0, 1.0]],
                     dtype=x.dtype, device=x.device) / 13.0
    blurred = conv2d_f32(F.pad(x, (1, 1, 1, 1)),
                         k.expand(c, 1, 3, 3).contiguous(), groups=c)
    mask = torch.zeros(x.shape[-2:], dtype=x.dtype, device=x.device)
    mask[1:-1, 1:-1] = 1.0
    blurred = blurred * mask + x * (1.0 - mask)
    out = torch.clamp(factor * x + (1.0 - factor) * blurred, 0.0, 1.0)
    return out[:, 0] if squeeze else out


class Weak:
    """HFlip(.5) -> VFlip(.5) -> Rot90(k ~ U{0..3}), all geometric, so a
    mask gets the same treatment."""

    @staticmethod
    def draw(generator, x):
        del x
        return {"hflip": _coin(generator), "vflip": _coin(generator),
                "k": int(torch.randint(0, 4, (), generator=generator))}

    @staticmethod
    def apply(draws, x, is_mask=False):
        del is_mask  # all transforms are geometric
        if draws["hflip"]:
            x = hflip(x)
        if draws["vflip"]:
            x = vflip(x)
        return rot90(x, draws["k"])


class Strong:
    """HFlip(.5) -> VFlip(.5) -> maybe Rotate(U(-90, 90)) -> [images only]
    maybe GaussianNoise(5e-4) -> maybe AdjustSharpness(0.5)."""

    @staticmethod
    def draw(generator, x):
        draws = {"hflip": _coin(generator), "vflip": _coin(generator),
                 "rotate": _coin(generator),
                 "angle": float(torch.rand((), generator=generator)
                                * 180.0 - 90.0),
                 "noise": _coin(generator), "noise_seed": int(torch.randint(
                     0, 2 ** 62, (), generator=generator)),
                 "sharpen": _coin(generator)}
        if draws["noise"]:
            gen = torch.Generator(x.device).manual_seed(draws["noise_seed"])
            draws["noise_plane"] = torch.randn(x.shape, generator=gen,
                                               device=x.device,
                                               dtype=x.dtype)
        return draws

    @staticmethod
    def apply(draws, x, is_mask=False):
        if draws["hflip"]:
            x = hflip(x)
        if draws["vflip"]:
            x = vflip(x)
        if draws["rotate"]:
            x = rotate(x, draws["angle"])
        if not is_mask:
            if draws["noise"]:
                x = add_gaussian_noise(x, draws["noise_plane"])
            if draws["sharpen"]:
                x = adjust_sharpness(x)
        return x


AUGMENTATIONS = {"none": None, "weak": Weak, "strong": Strong}


def get_augmentation(kind):
    """'none' -> None; 'weak' / 'strong' -> a class with ``draw(generator,
    x)`` and ``apply(draws, x, is_mask=False)``."""
    if kind not in AUGMENTATIONS:
        raise ValueError(f"augmentation must be one of "
                         f"{sorted(AUGMENTATIONS)}, got {kind!r}")
    return AUGMENTATIONS[kind]
