"""Affine-free BatchNorm with the reference's torch semantics (port of
``raw2logit_tpu/isp/batchnorm.py``: ``torch_bn_forward``,
``bn_input_cotangent`` and ``TorchBatchNorm``).

The reference processor ends in ``nn.BatchNorm2d(3, affine=False)``:
momentum 0.1 (``r = 0.9 r + 0.1 batch``), normalisation with the biased
batch variance, the running variance updated with the unbiased one, eps
1e-5. The port computes it as the JAX package's train step does, in
closed form on the planar (B, C, H, W) layout: per-channel reductions
over (0, 2, 3) and elementwise passes, with the textbook backward
``r (dy - mean(dy) - xhat mean(dy xhat))``. (PyTorch's native batch-norm
kernels parallelise over the channels, of which this one has three.)
"""

import torch
import torch.nn as nn
from torch.autograd.function import once_differentiable

from raw2logit_tpu_torch.parallel import distributed

_AXES = (0, 2, 3)


def _bcast(v):
    return v[:, None, None]


def _normalise(x, epsilon):
    """(y, batch mean, biased batch variance, r = rsqrt(var + eps)) of a
    (B, C, H, W) tensor over its channel axis 1."""
    var, mean = torch.var_mean(x, dim=_AXES, correction=0)
    r = torch.rsqrt(var + epsilon)
    return (x - _bcast(mean)).mul_(_bcast(r)), mean, var, r


def _running(stats, mean, var, n, momentum):
    """``stats`` with {"mean", "var"} moved toward the batch's mean and
    unbiased variance by ``momentum`` (torch's convention)."""
    unbiased = var * (n / max(n - 1, 1))
    return dict(stats,
                mean=(1 - momentum) * stats["mean"] + momentum * mean,
                var=(1 - momentum) * stats["var"] + momentum * unbiased)


def torch_bn_forward(x, stats, training, momentum=0.1, epsilon=1e-5):
    """Functional affine-free batch norm over channel axis 1: returns (y,
    new_stats), stats = {"mean", "var"} running values. In train mode y
    normalises with the batch mean and biased variance, and new_stats
    are ``(1 - momentum) r + momentum batch`` with the unbiased batch
    variance; in eval mode y uses ``stats``, which come back as they
    are."""
    if not training:
        return ((x - _bcast(stats["mean"]))
                * torch.rsqrt(_bcast(stats["var"]) + epsilon)), stats
    y, mean, var, _ = _normalise(x, epsilon)
    return y, _running(stats, mean, var, x.numel() // x.shape[1], momentum)


def bn_input_cotangent(x, dy, stats, training, epsilon=1e-5, batch=None):
    """Input cotangent of ``torch_bn_forward`` for output cotangent dy. In
    train mode ``r (dy - mean(dy) - xhat mean(dy xhat))`` with the batch
    statistics, xhat = (x - mu) r and r = rsqrt(var + eps); ``batch`` =
    (xhat, r) hands them in where the caller kept them (the train-mode
    output is xhat), else they come from x. In eval mode ``dy rsqrt(var +
    eps)`` with the running variance of ``stats``."""
    if not training:
        return dy * _bcast(torch.rsqrt(stats["var"] + epsilon))
    if batch is None:
        xhat, _, _, r = _normalise(x, epsilon)
    else:
        xhat, r = batch
    r = _bcast(r)
    m1 = _bcast(dy.mean(_AXES))
    m2 = _bcast((dy * xhat).mean(_AXES))
    return (dy - m1).sub_(xhat * m2).mul_(r)


class _TrainBatchNorm(torch.autograd.Function):
    """``apply(x, eps)`` -> (y, batch mean, biased batch variance): the
    train-mode forward of ``torch_bn_forward``, with
    ``bn_input_cotangent`` as its backward. The forward saves its output
    y = (x - mu) r, which is bitwise the xhat that the cotangent would
    recompute from x (the classifier keeps y alive anyway, x is freed),
    and r = rsqrt(var + eps); the statistics get no gradient."""

    @staticmethod
    def forward(ctx, x, eps):
        y, mean, var, r = _normalise(x, eps)
        ctx.save_for_backward(y, r)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, _d_mean, _d_var):
        y, r = ctx.saved_tensors
        return bn_input_cotangent(None, dy.contiguous(), None, True,
                                  batch=(y, r)), None


class TorchBatchNorm(nn.BatchNorm2d):
    """Channel-first (B, C, H, W) batch norm without scale or bias: the
    buffers, state dict and running-statistics semantics of
    ``nn.BatchNorm2d(C, affine=False)``, computed by ``torch_bn_forward``
    and ``bn_input_cotangent`` (train mode through ``_TrainBatchNorm``;
    eval mode by autograd of its two elementwise operations, whose
    cotangent is ``dy rsqrt(var + eps)``). Under a process group the
    train-mode statistics are the global batch's
    (``distributed.sync_batch_norm``)."""

    def __init__(self, num_features=3, device=None):
        super().__init__(num_features, eps=1e-5, momentum=0.1, affine=False,
                         device=device)

    def forward(self, x):
        self._check_input_dim(x)
        stats = {"mean": self.running_mean, "var": self.running_var}
        if not self.training:
            return torch_bn_forward(x, stats, False, epsilon=self.eps)[0]
        if distributed.active():
            y, mean, var, n = distributed.sync_batch_norm(x, eps=self.eps)
        else:
            y, mean, var = _TrainBatchNorm.apply(x, self.eps)
            n = x.numel() // x.shape[1]
        with torch.no_grad():
            new = _running(stats, mean, var, n, self.momentum)
            self.running_mean.copy_(new["mean"])
            self.running_var.copy_(new["var"])
            self.num_batches_tracked.add_(1)
        return y
