"""PyTorch port vs nn.BatchNorm2d and the JAX package: the ISP's output
batch norm (``raw2logit_tpu_torch/isp/batchnorm.py``: ``torch_bn_forward``,
``bn_input_cotangent``, ``TorchBatchNorm``).

All on the CPU, float32, at small sizes. Inputs are made with numpy from a
seed and handed to every implementation: per-channel means and spreads
that differ (0.3 +- 0.5, -1 +- 2, 2 +- 0.25), as the ISP's colour channels
do. References: ``nn.BatchNorm2d(3, affine=False)`` (autograd for the
input gradient), JAX's ``torch_bn_forward`` / ``bn_input_cotangent`` on
the planar layout (axis=1) and JAX's flax ``TorchBatchNorm`` module on the
channel-last layout.
"""

import flax.linen  # noqa: F401  (the JAX module below is a flax module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.isp import batchnorm as jbn

from raw2logit_tpu_torch.isp import TorchBatchNorm
from raw2logit_tpu_torch.isp.batchnorm import (bn_input_cotangent,
                                               torch_bn_forward)

SHAPES = ((2, 3, 8, 10), (4, 3, 16, 16), (1, 3, 5, 7))
REFERENCES = ("nn", "jax_functions", "jax_module")
MODES = ("train", "eval")
# Normalised outputs, abs: the batch mean and variance are float32 sums in
# another order in each implementation, and x - mean cancels to the
# input's rounding (2.4e-7 at |x| ~ 2) over the smallest spread (0.25),
# about 1e-6 a rounding; a few roundings apart.
Y_ATOL = 1e-5
# Input gradients, max |error| over max |reference|: the same statistics
# under two more mean reductions (of dy and dy xhat).
GRAD_REL = 1e-5
# Running statistics: one float32 update step from the same statistics.
STATS_RTOL, STATS_ATOL = 1e-6, 1e-7
STEPS = 3


def inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    loc = np.array([0.3, -1.0, 2.0])[:, None, None]
    scale = np.array([0.5, 2.0, 0.25])[:, None, None]
    x = (rng.normal(size=shape) * scale + loc).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)
    return x, dy


def running_start(seed=1):
    """Running statistics away from their initial 0 and 1."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=3).astype(np.float32) * 0.5,
            rng.uniform(0.5, 2.0, size=3).astype(np.float32))


def port_module(stats, training):
    bn = TorchBatchNorm(3)
    bn.running_mean.copy_(torch.from_numpy(stats[0]))
    bn.running_var.copy_(torch.from_numpy(stats[1]))
    return bn.train(training)


def run_port(xs, dy, stats, training):
    """The port's module over the batches ``xs``: (last output, input
    gradient of the last batch under dy, the module)."""
    bn = port_module(stats, training)
    for x in xs:
        xt = torch.from_numpy(x).requires_grad_(True)
        y = bn(xt)
    y.backward(torch.from_numpy(dy))
    return y.detach().numpy(), xt.grad.numpy(), bn


def run_reference(kind, xs, dy, stats, training):
    """(last output, input gradient of the last batch, running mean,
    running var) of a reference over the batches ``xs``."""
    if kind == "nn":
        bn = torch.nn.BatchNorm2d(3, affine=False)
        bn.running_mean.copy_(torch.from_numpy(stats[0]))
        bn.running_var.copy_(torch.from_numpy(stats[1]))
        bn.train(training)
        for x in xs:
            xt = torch.from_numpy(x).requires_grad_(True)
            y = bn(xt)
        y.backward(torch.from_numpy(dy))
        return (y.detach().numpy(), xt.grad.numpy(),
                bn.running_mean.numpy(), bn.running_var.numpy())
    st = {"mean": jnp.asarray(stats[0]), "var": jnp.asarray(stats[1])}
    if kind == "jax_functions":
        for x in xs:
            prev = st
            y, st = jbn.torch_bn_forward(jnp.asarray(x), st, training,
                                         axis=1)
        g = jbn.bn_input_cotangent(jnp.asarray(xs[-1]), jnp.asarray(dy),
                                   prev, training, axis=1)
        return (np.asarray(y), np.asarray(g), np.asarray(st["mean"]),
                np.asarray(st["var"]))
    module = jbn.TorchBatchNorm()
    nhwc = [jnp.asarray(x.transpose(0, 2, 3, 1)) for x in xs]
    variables = {"batch_stats": st}
    for x in nhwc:
        prev = variables
        y, mut = module.apply(variables, x,
                              use_running_average=not training,
                              mutable=["batch_stats"])
        variables = {"batch_stats": mut["batch_stats"]}

    def out(x):
        return module.apply(prev, x, use_running_average=not training,
                            mutable=["batch_stats"])[0]

    _, vjp = jax.vjp(out, nhwc[-1])
    g = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)))[0]
    st = variables["batch_stats"]
    return (np.asarray(y).transpose(0, 3, 1, 2),
            np.asarray(g).transpose(0, 3, 1, 2), np.asarray(st["mean"]),
            np.asarray(st["var"]))


def batches(shape, n=STEPS):
    return [inputs(shape, seed=s)[0] for s in range(n)], inputs(shape)[1]


def grad_rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("reference", REFERENCES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_output_matches(shape, mode, reference):
    xs, dy = batches(shape)
    stats = running_start()
    got = run_port(xs, dy, stats, mode == "train")[0]
    want = run_reference(reference, xs, dy, stats, mode == "train")[0]
    np.testing.assert_allclose(got, want, rtol=0, atol=Y_ATOL)


@pytest.mark.parametrize("reference", REFERENCES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_input_gradient_matches(shape, mode, reference):
    xs, dy = batches(shape)
    stats = running_start()
    got = run_port(xs, dy, stats, mode == "train")[1]
    want = run_reference(reference, xs, dy, stats, mode == "train")[1]
    assert grad_rel(got, want) <= GRAD_REL


@pytest.mark.parametrize("reference", REFERENCES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_running_statistics_match(shape, mode, reference):
    """After STEPS batches: the running mean and variance (moved in train
    mode, untouched in eval mode) and, against nn.BatchNorm2d, the count
    of tracked batches."""
    xs, dy = batches(shape)
    stats = running_start()
    bn = run_port(xs, dy, stats, mode == "train")[2]
    _, _, mean, var = run_reference(reference, xs, dy, stats,
                                    mode == "train")
    np.testing.assert_allclose(bn.running_mean.numpy(), mean,
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), var,
                               rtol=STATS_RTOL, atol=STATS_ATOL)
    if mode == "eval":
        np.testing.assert_array_equal(bn.running_mean.numpy(), stats[0])
        np.testing.assert_array_equal(bn.running_var.numpy(), stats[1])
    assert int(bn.num_batches_tracked) == (STEPS if mode == "train" else 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_functions_match_jax(shape, mode):
    """The port's functions against JAX's on the planar layout: output,
    new statistics, and the cotangent with the statistics computed from x
    and with xhat and r handed in."""
    x, dy = inputs(shape)
    training = mode == "train"
    mean0, var0 = running_start()
    y, st = torch_bn_forward(
        torch.from_numpy(x),
        {"mean": torch.from_numpy(mean0), "var": torch.from_numpy(var0)},
        training)
    jy, jst = jbn.torch_bn_forward(
        jnp.asarray(x), {"mean": jnp.asarray(mean0),
                         "var": jnp.asarray(var0)}, training, axis=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                               atol=Y_ATOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   rtol=STATS_RTOL, atol=STATS_ATOL)
    stats = {"mean": torch.from_numpy(mean0), "var": torch.from_numpy(var0)}
    want = np.asarray(jbn.bn_input_cotangent(
        jnp.asarray(x), jnp.asarray(dy), {"mean": jnp.asarray(mean0),
                                          "var": jnp.asarray(var0)},
        training, axis=1))
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    got = bn_input_cotangent(xt, dyt, stats, training)
    assert grad_rel(got.numpy(), want) <= GRAD_REL
    if training:
        x64 = xt.double()
        mean = x64.mean((0, 2, 3)).float()
        r = torch.rsqrt(x64.var((0, 2, 3), unbiased=False).float() + 1e-5)
        xhat = (xt - mean[:, None, None]) * r[:, None, None]
        handed = bn_input_cotangent(None, dyt, None, True, batch=(xhat, r))
        assert grad_rel(handed.numpy(), want) <= GRAD_REL


def test_state_dict_is_batchnorm2d():
    """The port's module and nn.BatchNorm2d(3, affine=False) load each
    other's state dicts: the same buffers under the same names."""
    ref = torch.nn.BatchNorm2d(3, affine=False)
    ref.running_mean.fill_(0.25)
    ref.running_var.fill_(3.0)
    ref.num_batches_tracked.fill_(7)
    bn = TorchBatchNorm(3)
    bn.load_state_dict(ref.state_dict())
    assert set(bn.state_dict()) == set(ref.state_dict())
    for k, v in ref.state_dict().items():
        assert torch.equal(bn.state_dict()[k], v), k
