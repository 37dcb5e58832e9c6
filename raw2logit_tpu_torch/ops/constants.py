"""Fixed ISP constants (numpy copy of ``raw2logit_tpu/ops/constants.py``).

Standard published values: ITU-R BT.601 / skimage Rec.601 YUV transform,
textbook bilinear CFA stencils, the identity-plus-Laplacian sharpening
stencil and a sigma-0.5 radius-2 Gaussian. ``on_device`` hands them to
the ops as tensors.
"""

import functools

import numpy as np
import torch

# Bilinear CFA interpolation stencils, applied to the sparse scattered
# mosaic (3/4 of R/B sites and 1/2 of G sites are zero).
K_G = np.array([[0.0, 1.0, 0.0],
                [1.0, 4.0, 1.0],
                [0.0, 1.0, 0.0]], dtype=np.float32) / 4.0

K_RB = np.array([[1.0, 2.0, 1.0],
                 [2.0, 4.0, 2.0],
                 [1.0, 2.0, 1.0]], dtype=np.float32) / 4.0

# Rec.601 RGB->YUV (skimage.color.rgb2yuv); YUV->RGB is its exact inverse.
M_RGB_2_YUV = np.array(
    [[0.299, 0.587, 0.114],
     [-0.14714119, -0.28886916, 0.43601035],
     [0.61497538, -0.51496512, -0.10001026]], dtype=np.float64)
M_YUV_2_RGB = np.linalg.inv(M_RGB_2_YUV)

M_RGB_2_YUV = M_RGB_2_YUV.astype(np.float32)
M_YUV_2_RGB = M_YUV_2_RGB.astype(np.float32)

# 3x3 sharpening stencil: identity + discrete Laplacian.
K_SHARP = np.array([[0.0, -1.0, 0.0],
                    [-1.0, 5.0, -1.0],
                    [0.0, -1.0, 0.0]], dtype=np.float32)


def _gaussian_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).astype(np.float32)


# 5x5 separable Gaussian, sigma=0.5, truncated at radius 2
# (scipy.ndimage.gaussian_filter(sigma=0.5)).
G_BLUR_1D = _gaussian_1d(0.5, 2)
K_BLUR = np.outer(G_BLUR_1D, G_BLUR_1D).astype(np.float32)

# Default camera parameters: no black level, unit white balance, identity
# CCM.
DEFAULT_CAMERA_PARAMS = (
    [0.0, 0.0, 0.0, 0.0],
    [1.0, 1.0, 1.0],
    [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0],
)


@functools.lru_cache(maxsize=None)
def _device_constant(values, shape, dtype, device):
    """The kept tensor, made outside inference mode whatever mode its first
    caller runs in, so that autograd may save it later."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device).reshape(shape)


def on_device(a, dtype, device):
    """``torch.as_tensor(a, dtype=dtype, device=device)``, but an array or
    list ``a`` (not a tensor) is copied to ``device`` once per value, dtype
    and device and then kept: a copy from pageable host memory to the card
    waits for the card, and the ops run inside batches that must not wait.
    The tensor is shared: do not write into it."""
    if isinstance(a, torch.Tensor):
        return torch.as_tensor(a, dtype=dtype, device=device)
    a = np.asarray(a, np.float64)
    return _device_constant(tuple(a.ravel().tolist()), a.shape, dtype,
                            torch.device(device))
