"""Pointwise colour ops: white balance, CCM, YUV, gammas (port of
``raw2logit_tpu/ops/color.py``).

All ops take NCHW ``(B, 3, H, W)`` (or ``(3, H, W)``) float tensors: the
colour axis is dim -3.
"""

import torch

from raw2logit_tpu_torch.ops import constants


def _mix(img, m):
    """out_k = sum_c m[k, c] * img_c over the colour axis (dim -3), as
    elementwise products and sums: no matrix product, so no TF32 on the
    card in either direction (the JAX package pins these einsums to
    ``Precision.HIGHEST``), and a contiguous NCHW result."""
    m = constants.on_device(m, img.dtype, img.device).reshape(3, 3)
    c0, c1, c2 = img.unbind(-3)
    return torch.stack([m[k, 0] * c0 + m[k, 1] * c1 + m[k, 2] * c2
                        for k in range(3)], dim=-3)


def white_balance(rgb, wb):
    """Per-channel gain (the reference's broadcast multiply by a (1, 3)
    white balance)."""
    wb = constants.on_device(wb, rgb.dtype, rgb.device)
    return rgb * wb.reshape(-1)[-3:].reshape(3, 1, 1)


def colour_correction(rgb, ccm):
    """3x3 colour-matrix transform: out_k = sum_c M[k, c] * in_c."""
    return _mix(rgb, ccm)


def rgb_to_yuv(rgb):
    """Rec.601 RGB->YUV (skimage.color.rgb2yuv constants)."""
    return _mix(rgb, constants.M_RGB_2_YUV)


def yuv_to_rgb(yuv):
    return _mix(yuv, constants.M_YUV_2_RGB)


def adjust_gamma(img, gamma):
    """Static-pipeline gamma: ``img ** (1 / gamma)``, after the caller's
    clip to [0, 1]."""
    return img ** (1.0 / gamma)


def clip_gamma_exp(img, gamma):
    """Parametrized-pipeline gamma: clip to [1e-5, 1], then
    ``exp(log(x) / gamma)`` so that d/dgamma exists. Returns
    (clipped, gamma_corrected)."""
    clipped = img.clamp(1e-5, 1.0)
    return clipped, torch.exp(torch.log(clipped) / gamma)
