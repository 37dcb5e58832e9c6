"""Small-stencil spatial filters (port of the parts of
``raw2logit_tpu/ops/filters.py`` and ``isp/parametrized.py`` that the
differentiable ISP uses).

Padding modes:

  * ``zero``    - torch Conv2d default
  * ``reflect`` - torch padding_mode='reflect' / np.pad 'reflect'
                  (edge NOT repeated: dcb|abcd)

The JAX package pins these convolutions to ``Precision.HIGHEST``; here
``conv2d_f32`` computes them in full float32 on the card whatever TF32
settings the caller has (cuDNN runs float32 convolutions in TF32 by
default).
"""

import contextlib

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

_PAD_MODES = {"zero": "constant", "reflect": "reflect"}


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
    kw)). Correlation, as torch Conv2d: the learned kernels need not stay
    symmetric."""
    if pad_mode not in _PAD_MODES:
        raise ValueError(f"pad_mode must be one of {sorted(_PAD_MODES)}, "
                         f"got {pad_mode!r}")
    kernel = torch.as_tensor(kernel, dtype=x.dtype, device=x.device)
    kh, kw = kernel.shape[-2:]
    lead = x.shape[:-2]
    xp = x.reshape(-1, 1, *x.shape[-2:])
    xp = F.pad(xp, (kw // 2, kw // 2, kh // 2, kh // 2),
               mode=_PAD_MODES[pad_mode])
    out = conv2d_f32(xp, kernel.reshape(1, 1, kh, kw))
    return out.reshape(*lead, *out.shape[-2:])


def debayer_conv(mosaic, weight):
    """Full 3x3 conv over the scattered (B, 3, H, W) mosaic with torch
    'reflect' padding; ``weight`` is OIHW (co, ci, 3, 3)."""
    return conv2d_f32(F.pad(mosaic, (1, 1, 1, 1), mode="reflect"), weight)
