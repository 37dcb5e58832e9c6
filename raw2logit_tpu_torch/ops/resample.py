"""Resampling of (..., H, W) planes: what the JAX package's corruptions
take from ``jax.scipy.ndimage.map_coordinates`` (order 1) and
``jax.image.resize`` (``linear``, ``nearest``).

Both are written as explicit index maps and gathers with JAX's semantics,
not as ``grid_sample`` or ``F.interpolate``: their boundary modes and
pixel-centre conventions do not map onto JAX's one to one. Index maps and
weights that depend only on shapes are computed once on the CPU in
float32, in JAX's order, and kept on each device they are asked for
(``cached_on``), so that a batch on the card copies nothing from the
host.
"""

import functools

import numpy as np
import torch

from raw2logit_tpu_torch.ops.filters import full_float32

MODES = ("constant", "mirror", "reflect")


def _mirror_index(index, size):
    """scipy 'mirror' (dcb|abcd|cba): JAX's triangular wave."""
    s = size - 1
    return ((index + s).remainder(2 * s) - s).abs()


def _reflect_index(index, size):
    """scipy 'reflect' (dcba|abcd|dcba)."""
    return torch.div(_mirror_index(2 * index + 1, 2 * size + 1) - 1, 2,
                     rounding_mode="floor")


def _taps(coord, size, mode):
    """The two order-1 taps of ``coord`` along an axis of ``size``:
    [(index, valid, weight), ...] with JAX's index fixer applied; ``valid``
    is None where every tap is valid (all modes but 'constant')."""
    lower = torch.floor(coord)
    upper_weight = coord - lower
    lower_weight = 1 - upper_weight
    index = lower.to(torch.int64)
    taps = []
    for i, w in ((index, lower_weight), (index + 1, upper_weight)):
        if mode == "constant":
            taps.append((i.clamp(0, size - 1), (i >= 0) & (i < size), w))
        elif mode == "mirror":
            taps.append((_mirror_index(i, size), None, w))
        else:
            taps.append((_reflect_index(i, size), None, w))
    return taps


def map_coordinates(plane, coords, mode="constant"):
    """``jax.scipy.ndimage.map_coordinates(plane, coords, order=1,
    mode=mode)`` (cval 0) over the last two dims of ``plane`` (..., H, W):
    ``coords = (cy, cx)``, two float tensors of one shape S on the plane's
    device; returns (..., *S). The coordinates are cast to the plane's
    dtype; the four taps are summed in JAX's order, each weighted by
    ``wy * wx``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    h, w = plane.shape[-2:]
    cy, cx = (c.to(plane.dtype) for c in coords)
    out = None
    for iy, vy, wy in _taps(cy, h, mode):
        for ix, vx, wx in _taps(cx, w, mode):
            val = plane[..., iy, ix]
            if vy is not None:
                val = torch.where(vy & vx, val, 0.0)
            term = (wy * wx) * val
            out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=None)
def cached_on(device, fn, *args):
    """``fn(*args).to(device)``, computed and copied once per device, ``fn``
    and arguments (hashable), outside inference mode (so that autograd
    may save it after an inference-mode caller filled the cache); the
    tensor is shared: do not write into it."""
    with torch.inference_mode(False):
        return fn(*args).to(device)


def _linear_weights(n_in, n_out):
    """JAX's ``compute_weight_mat`` for the triangle kernel with
    ``antialias=True`` (the kernel widened by the inverse scale when
    downsampling), no translation: (n_in, n_out) float32."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale
              - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / torch.tensor(kernel_scale, dtype=torch.float32)
    weights = torch.clamp(1 - x.abs(), min=0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def _nearest_index(n_in, n_out):
    """JAX's ``_resize_nearest`` index map, floor((i + 0.5) * n_in / n_out)
    (half-pixel centres: torch's 'nearest-exact'), in float32 as XLA
    compiles it: ``* n_in / n_out`` folded into one factor, n_in times the
    float32 reciprocal of n_out (at 32 -> 40 and 40 -> 50, both a scale of
    0.8, the factor rounds to either side of 0.8, and output 2 of the
    latter takes input 1)."""
    one = np.float32(1.0)
    scale = float(np.float32(n_in) * (one / np.float32(n_out)))
    offsets = (torch.arange(n_out, dtype=torch.float32) + 0.5) * scale
    return torch.floor(offsets).to(torch.int64)


def resize(x, size, method):
    """``jax.image.resize`` of the last two dims of ``x`` (..., H, W) to
    ``size`` = (h, w): ``method`` 'linear' (triangle kernel, antialiased
    on downscale, as ``scale_and_translate``; a product with each axis's
    weight matrix in full float32) or 'nearest'. An axis whose size does
    not change is left as it is, as in JAX."""
    for axis, n_out in zip((-2, -1), size):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        if method == "nearest":
            x = x.index_select(axis, cached_on(x.device, _nearest_index,
                                               n_in, n_out))
            continue
        if method != "linear":
            raise ValueError(f"method must be 'linear' or 'nearest', got "
                             f"{method!r}")
        wm = cached_on(x.device, _linear_weights, n_in, n_out).to(x.dtype)
        with full_float32():
            x = (torch.matmul(wm.t(), x) if axis == -2
                 else torch.matmul(x, wm))
    return x
