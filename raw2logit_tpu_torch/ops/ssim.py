"""Differentiable SSIM (port of ``raw2logit_tpu/ops/ssim.py``, after the
reference's pytorch-ssim): an 11x11 gaussian window (sigma 1.5),
per-channel convolutions with ZERO 'same' padding, C1 = 0.01^2,
C2 = 0.03^2, on planar (B, C, H, W) images.

The window is the outer product of a 1-D gaussian, so the convolution
factorises exactly into a vertical then a horizontal 11-tap pass (zero
padding commutes with the factorisation); ``separable=False`` runs the
dense 11x11 window. Both run in full float32 on the card
(``ops.filters.conv2d_f32``), as the JAX package pins them to
``Precision.HIGHEST``.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from raw2logit_tpu_torch.ops.filters import conv2d_f32

C1, C2 = 0.01 ** 2, 0.03 ** 2


@functools.lru_cache(maxsize=None)
def gauss_np(window_size, sigma=1.5):
    """The 1-D gaussian taps in float32 (``_gauss_np`` of the JAX
    package, computed in float64 and rounded once)."""
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return g.astype(np.float32)


def _depthwise(img, k):
    """Per-channel correlation of (B, C, H, W) with the (kh, kw) window
    ``k``, zero 'same' padding."""
    c = img.shape[1]
    kh, kw = k.shape
    w = torch.as_tensor(k, dtype=img.dtype, device=img.device)
    w = w.expand(c, 1, kh, kw).contiguous()
    xp = F.pad(img, (kw // 2, kw // 2, kh // 2, kh // 2))
    return conv2d_f32(xp, w, groups=c)


def _conv_win(img, window_size, separable=True):
    g = gauss_np(int(window_size))
    if separable:
        return _depthwise(_depthwise(img, g[:, None]), g[None, :])
    return _depthwise(img, np.outer(g, g).astype(np.float32))


def ssim(img1, img2, window_size=11, size_average=True, separable=True):
    """SSIM between two planar (B, C, H, W) batches. ``size_average``
    gives the scalar mean; else the per-image mean over (C, H, W)."""
    conv = functools.partial(_conv_win, window_size=int(window_size),
                             separable=separable)
    mu1 = conv(img1)
    mu2 = conv(img2)

    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(img1 * img1) - mu1_sq
    sigma2_sq = conv(img2 * img2) - mu2_sq
    sigma12 = conv(img1 * img2) - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))

    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))
