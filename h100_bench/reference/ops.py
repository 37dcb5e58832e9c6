"""The layers of the reference and their state-dict entries: convolution
and linear layers in float32 or, for the control, with TF32's rounding of
their operands; flax "SAME" padding; batch norm over dicts of tensors."""

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


BN_EPS = 1e-5


def conv_spec(out, name, c_out, c_in, k):
    """Append a bias-free k x k conv's weight to a spec."""
    out.append((f"{name}.weight", (c_out, c_in, k, k), "conv"))


def bn_spec(out, name, c):
    """Append a batch norm's entries to a spec, in ``state_dict()``
    order."""
    out += [(f"{name}.weight", (c,), "bn_weight"),
            (f"{name}.bias", (c,), "bn_bias"),
            (f"{name}.running_mean", (c,), "running_mean"),
            (f"{name}.running_var", (c,), "running_var"),
            (f"{name}.num_batches_tracked", (), "count")]


def batch_norm(p, name, x, train):
    """Batch norm ``name`` of ``p``: the batch's biased statistics in
    train mode, the running statistics in eval mode (eps 1e-5)."""
    if train:
        return F.batch_norm(x, None, None, p[f"{name}.weight"],
                            p[f"{name}.bias"], True, 0.0, BN_EPS)
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p[f"{name}.weight"],
                        p[f"{name}.bias"], False, 0.0, BN_EPS)


def same_pad(x, k, s):
    """flax SAME padding of NCHW ``x`` for a k x k conv of stride s: the
    output is ceil(n / s), the extra pixel padded at the end."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def conv_same(p, name, x, s, tf32):
    """Conv ``name`` of ``p`` on ``x`` at stride ``s``, padded flax
    SAME."""
    w = p[f"{name}.weight"]
    return conv2d(same_pad(x, w.shape[-1], s), w, tf32, stride=s)
