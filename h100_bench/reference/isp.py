"""The parametrized ISP in plain PyTorch (a frozen copy of the math of
the port's ``isp/parametrized.py`` and ``ops/``, without stage tracking):
raw (B, H, W) -> RGB (B, 3, H, W).

black level on the RGGB scatter -> 3x3 debayer conv (reflect padding) ->
white balance -> colour matrix -> YUV -> 3x3 sharpening of Y (zero
padding) -> 5x5 Gaussian blur of Y (reflect padding) -> RGB -> clip to
[1e-5, 1] -> exp(log(x) / gamma) -> optional additive layer ->
affine-free batch norm (torch semantics: biased variance, eps 1e-5).
"""

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.ops import conv2d

K_G = np.array([[0.0, 1.0, 0.0], [1.0, 4.0, 1.0], [0.0, 1.0, 0.0]],
               np.float32) / 4.0
K_RB = np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]],
                np.float32) / 4.0
K_SHARP = np.array([[0.0, -1.0, 0.0], [-1.0, 5.0, -1.0], [0.0, -1.0, 0.0]],
                   np.float32)
_RGB_2_YUV = np.array([[0.299, 0.587, 0.114],
                       [-0.14714119, -0.28886916, 0.43601035],
                       [0.61497538, -0.51496512, -0.10001026]], np.float64)
M_RGB_2_YUV = _RGB_2_YUV.astype(np.float32)
M_YUV_2_RGB = np.linalg.inv(_RGB_2_YUV).astype(np.float32)


def _blur_kernel():
    """5x5 Gaussian, sigma 0.5, radius 2, as an outer product."""
    x = np.arange(-2, 3, dtype=np.float64)
    g = np.exp(-0.5 * (x / 0.5) ** 2)
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g).astype(np.float32)


K_BLUR = _blur_kernel()
BN_EPS = 1e-5


def initial_params(camera, image_size, additive_layer, device):
    """The ISP's initial parameters and buffers under the port's state
    dict names: the camera's black level, white balance and colour
    matrix, gamma 2.2, the fixed stencils, the zero additive layer where
    there is one, and fresh batch-norm statistics."""
    black_level, white_balance, colour_matrix = camera
    deb = np.zeros((3, 3, 3, 3), np.float32)
    deb[0, 0], deb[1, 1], deb[2, 2] = K_RB, K_G, K_RB

    def t(a, shape=None):
        out = torch.tensor(np.asarray(a, np.float32), device=device)
        return out.reshape(shape) if shape else out

    params = {"black_level": t(black_level),
              "white_balance": t(white_balance, (1, 3)),
              "colour_correction": t(colour_matrix, (3, 3)),
              "gamma_correct": t([2.2]),
              "sharpening_filter.weight": t(K_SHARP, (1, 1, 3, 3)),
              "gaussian_blur.weight": t(K_BLUR, (1, 1, 5, 5)),
              "debayer.weight": t(deb)}
    if additive_layer:
        params["additive_layer"] = torch.zeros(
            1, 3, image_size, image_size, device=device)
    buffers = {"batch_norm.running_mean": torch.zeros(3, device=device),
               "batch_norm.running_var": torch.ones(3, device=device),
               "batch_norm.num_batches_tracked": torch.zeros(
                   (), dtype=torch.long, device=device)}
    return params, buffers


def _mix(img, m):
    """out_k = sum_c m[k, c] img_c over the colour axis 1."""
    c0, c1, c2 = img.unbind(1)
    return torch.stack([m[k, 0] * c0 + m[k, 1] * c1 + m[k, 2] * c2
                        for k in range(3)], dim=1)


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _filter_y(y, kernel, pad, mode, tf32):
    """One plane (B, H, W) correlated with a (1, 1, k, k) kernel."""
    yp = F.pad(y[:, None], (pad, pad, pad, pad), mode=mode)
    return conv2d(yp, kernel, tf32)[:, 0]


def isp_forward(p, raw, bn_train, tf32=False):
    """RGB of ``raw`` under the parameters ``p``; the output batch norm
    normalises with the batch's statistics when ``bn_train``, else with
    fresh running statistics (mean 0, variance 1)."""
    bl = p["black_level"]
    b, h, w = raw.shape
    mosaic = raw.new_zeros((b, 3, h, w))
    mosaic[:, 0, 0::2, 0::2] = raw[:, 0::2, 0::2] - bl[0]
    mosaic[:, 1, 0::2, 1::2] = raw[:, 0::2, 1::2] - bl[1]
    mosaic[:, 1, 1::2, 0::2] = raw[:, 1::2, 0::2] - bl[2]
    mosaic[:, 2, 1::2, 1::2] = raw[:, 1::2, 1::2] - bl[3]
    rgb = conv2d(F.pad(mosaic, (1, 1, 1, 1), mode="reflect"),
                 p["debayer.weight"], tf32)
    rgb = rgb * p["white_balance"].reshape(3, 1, 1)
    rgb = _mix(rgb, p["colour_correction"])
    yuv = _mix(rgb, _const(M_RGB_2_YUV, rgb))
    y = _filter_y(yuv[:, 0], p["sharpening_filter.weight"], 1, "constant",
                  tf32)
    y = _filter_y(y, p["gaussian_blur.weight"], 2, "reflect", tf32)
    rgb = _mix(torch.cat([y[:, None], yuv[:, 1:]], dim=1),
               _const(M_YUV_2_RGB, rgb))
    rgb = torch.exp(torch.log(rgb.clamp(1e-5, 1.0)) / p["gamma_correct"])
    if "additive_layer" in p:
        rgb = rgb + p["additive_layer"]
    if not bn_train:
        return rgb * torch.rsqrt(torch.tensor(1.0 + BN_EPS, device=rgb.device))
    var, mean = torch.var_mean(rgb, dim=(0, 2, 3), correction=0)
    return ((rgb - mean[:, None, None])
            * torch.rsqrt(var + BN_EPS)[:, None, None])
