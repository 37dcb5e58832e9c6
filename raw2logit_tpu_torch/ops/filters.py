"""Small-stencil spatial filters on luma (Y) planes and NCHW RGB images
(port of ``raw2logit_tpu/ops/filters.py`` and of the convolutions of
``isp/parametrized.py``).

Padding modes; which one an op uses is part of its semantics, and a wrong
one shows only on the border rows and columns:

  * ``zero``      - torch Conv2d default / scipy convolve2d boundary='fill'
  * ``reflect``   - torch padding_mode='reflect' / np.pad 'reflect'
                    (edge NOT repeated: dcb|abcd)
  * ``symmetric`` - scipy.ndimage's default mode='reflect' / np.pad
                    'symmetric' (edge repeated: dcba|abcd)
  * ``edge``      - scipy/skimage mode='nearest' (replicate: aaa|abcd)

The JAX package pins these convolutions to ``Precision.HIGHEST``; here
``conv2d_f32`` computes them in full float32 on the card whatever TF32
settings the caller has (cuDNN runs float32 convolutions in TF32 by
default).
"""

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from raw2logit_tpu_torch.ops import constants

# F.pad's name of each mode; ``symmetric`` has none (``_symmetric_index``).
_PAD_MODES = {"zero": "constant", "reflect": "reflect",
              "symmetric": None, "edge": "replicate"}


def _symmetric_index(n, p, device):
    """Source indices of a length-``n`` axis padded by ``p`` on each side
    with np.pad 'symmetric' (period 2n, any ``p``)."""
    i = torch.arange(-p, n + p, device=device) % (2 * n)
    return torch.where(i < n, i, 2 * n - 1 - i)


def _pad2d(x, ph, pw, pad_mode):
    """Pad the last two dims of (..., H, W) by ``ph`` rows and ``pw``
    columns on each side."""
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {sorted(_PAD_MODES)}, "
                         f"got {pad_mode!r}")
    if pad_mode == "symmetric":
        h, w = x.shape[-2:]
        x = x.index_select(-2, _symmetric_index(h, ph, x.device))
        return x.index_select(-1, _symmetric_index(w, pw, x.device))
    lead = x.shape[:-2]
    xp = F.pad(x.reshape(-1, 1, *x.shape[-2:]), (pw, pw, ph, ph),
               mode=_PAD_MODES[pad_mode])
    return xp.reshape(*lead, *xp.shape[-2:])


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convolutions and cuBLAS matrix products while
    the block runs; the caller's settings are restored afterwards."""
    conv = torch.backends.cudnn.allow_tf32
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = matmul


class _Conv2dF32(torch.autograd.Function):
    """``F.conv2d`` (groups, stride, padding) whose forward and backward run
    under ``full_float32``: a backward runs after the caller's block has
    ended, so a context around the forward alone would leave it in TF32."""

    @staticmethod
    def forward(ctx, x, weight, groups, stride=1, padding=0):
        ctx.save_for_backward(x, weight)
        ctx.conv = dict(groups=groups, stride=stride, padding=padding)
        with full_float32():
            return F.conv2d(x, weight, **ctx.conv)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx = dw = None
        with full_float32():
            if ctx.needs_input_grad[0]:
                dx = torch.nn.grad.conv2d_input(x.shape, weight, g,
                                                **ctx.conv)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, weight.shape, g,
                                                 **ctx.conv)
        return (dx, dw) + (None,) * (len(ctx.needs_input_grad) - 2)


def conv2d_f32(x, weight, groups=1, stride=1, padding=0):
    """``F.conv2d(x, weight, groups=groups, stride=stride,
    padding=padding)`` in full float32 on the card (forward and backward).
    On the CPU, where there is no TF32, it is ``F.conv2d`` itself."""
    if x.device.type == "cpu":
        return F.conv2d(x, weight, groups=groups, stride=stride,
                        padding=padding)
    return _Conv2dF32.apply(x, weight, groups, stride, padding)


def conv2d_single(x, kernel, pad_mode="zero"):
    """2-D cross-correlation of (..., H, W) planes with one small kernel of
    shape (kh, kw) (leading singleton dims allowed, e.g. OIHW (1, 1, kh,
    kw)). Correlation, as torch Conv2d and the JAX package's
    ``conv_general_dilated``: the learned kernels need not stay
    symmetric."""
    kernel = constants.on_device(kernel, x.dtype, x.device)
    kh, kw = kernel.shape[-2:]
    xp = _pad2d(x, kh // 2, kw // 2, pad_mode)
    out = conv2d_f32(xp.reshape(-1, 1, *xp.shape[-2:]),
                     kernel.reshape(1, 1, kh, kw))
    return out.reshape(*x.shape[:-2], *out.shape[-2:])


def conv2d_separable(x, k1d, pad_mode):
    """A separable (outer-product) kernel as two rank-1 passes, vertical
    then horizontal, each axis padded on its own with ``pad_mode`` (as
    scipy applies correlate1d axis by axis)."""
    k1d = constants.on_device(k1d, x.dtype, x.device)
    x = conv2d_single(x, k1d[:, None], pad_mode=pad_mode)
    return conv2d_single(x, k1d[None, :], pad_mode=pad_mode)


def _on_luma(img, fn):
    """Apply ``fn`` to the Y plane of ``img`` (..., 3, H, W) in YUV space
    and return RGB (the reference's rgb2yuv -> op on Y -> yuv2rgb)."""
    from raw2logit_tpu_torch.ops.color import rgb_to_yuv, yuv_to_rgb
    y, u, v = rgb_to_yuv(img).unbind(-3)
    return yuv_to_rgb(torch.stack([fn(y), u, v], dim=-3))


def sharpen_y(img):
    """The fixed 3x3 sharpening stencil on Y, zero padding (scipy
    convolve2d 'same', boundary='fill')."""
    return _on_luma(img, lambda y: conv2d_single(y, constants.K_SHARP,
                                                 pad_mode="zero"))


def gaussian_blur_y(img):
    """Gaussian denoise on Y: scipy.ndimage.gaussian_filter(sigma=0.5)
    (radius 2, separable, symmetric padding)."""
    return _on_luma(img, lambda y: gaussian_filter_2d(y, 0.5, "symmetric"))


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma, truncate=4.0):
    """The normalised 1-D Gaussian of scipy, radius ``int(truncate *
    sigma + 0.5)``, float32, on the CPU."""
    return torch.from_numpy(constants._gaussian_1d(
        sigma, int(truncate * sigma + 0.5)))


def gaussian_filter_2d(x, sigma, pad_mode, truncate=4.0):
    """scipy.ndimage.gaussian_filter on (..., H, W) planes, each axis
    padded with ``pad_mode``."""
    k1d = gaussian_kernel_1d(float(sigma), float(truncate))
    return conv2d_separable(x, k1d.numpy(), pad_mode=pad_mode)


def unsharp_mask_y(img):
    """skimage.filters.unsharp_mask on Y with radius = amount = 1 and
    preserve_range=True: y + (y - gaussian(y, sigma=1, mode='nearest')),
    so edge padding and a 9-tap kernel."""
    return _on_luma(img, lambda y: y + (y - gaussian_filter_2d(y, 1.0,
                                                               "edge")))


def median_filter_y(img):
    """scipy.ndimage.median_filter(size=3) on Y, symmetric padding: the
    middle of the 9 shifted planes."""
    def _f(y):
        yp = _pad2d(y, 1, 1, "symmetric")
        h, w = y.shape[-2:]
        stack = torch.stack([yp[..., i:i + h, j:j + w]
                             for i in range(3) for j in range(3)], dim=-1)
        return stack.sort(dim=-1).values[..., 4]
    return _on_luma(img, _f)


FFT_KEEP_FRACTION = 0.3


def fft_denoise(img):
    """FFT low-pass of an NCHW image that keeps the reference's quirk:
    scipy.fftpack.fft2 of an HWC image transforms its last two axes, W and
    C, and the mid-frequency W columns are zeroed. Here that is the FFT
    over the colour and width dims (-3, -1), columns [0.3 W, 0.7 W) of
    the width zeroed; the real part, in ``img``'s dtype."""
    f = torch.fft.fftn(img, dim=(-3, -1))
    c = img.shape[-1]
    lo = int(c * FFT_KEEP_FRACTION)
    hi = int(c * (1 - FFT_KEEP_FRACTION))
    cols = torch.arange(c, device=img.device)
    f = f * ((cols < lo) | (cols >= hi))
    return torch.fft.ifftn(f, dim=(-3, -1)).real.to(img.dtype)


def debayer_conv(mosaic, weight):
    """Full 3x3 conv over the scattered (B, 3, H, W) mosaic with torch
    'reflect' padding; ``weight`` is OIHW (co, ci, 3, 3)."""
    return conv2d_f32(F.pad(mosaic, (1, 1, 1, 1), mode="reflect"), weight)
