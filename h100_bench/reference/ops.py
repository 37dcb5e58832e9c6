"""Convolution and linear layers of the reference, in float32 or, for the
control, with TF32's rounding of their operands."""

import torch
import torch.nn.functional as F


def round_tf32(x):
    """``x`` (float32) rounded to the nearest TF32 value (10 explicit
    mantissa bits, ties to even), as the tensor cores read their
    operands."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _Tf32Conv(torch.autograd.Function):
    """``F.conv2d`` whose forward reads TF32-rounded input and weight and
    whose backward reads a TF32-rounded cotangent as well."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, groups):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.conv = dict(stride=stride, padding=padding, groups=groups)
        return F.conv2d(xr, wr, **ctx.conv)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        g = round_tf32(g)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.nn.grad.conv2d_input(xr.shape, wr, g, **ctx.conv)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(xr, wr.shape, g, **ctx.conv)
        return dx, dw, None, None, None


def conv2d(x, w, tf32, stride=1, padding=0, groups=1):
    """Bias-free 2-D convolution (cross-correlation) of NCHW ``x``."""
    if tf32:
        return _Tf32Conv.apply(x, w, stride, padding, groups)
    return F.conv2d(x, w, stride=stride, padding=padding, groups=groups)


class _Tf32Linear(torch.autograd.Function):
    """``F.linear`` on TF32-rounded operands, forward and backward."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        g = round_tf32(g.contiguous())
        return g @ wr, g.t() @ xr, g.sum(0)


def linear(x, w, b, tf32):
    """``x @ w.T + b``."""
    if tf32:
        return _Tf32Linear.apply(x, w, b)
    return F.linear(x, w, b)
