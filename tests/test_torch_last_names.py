"""The JAX package's last public names in the port: the stem's two-stage
max pool (``models.resnet.stem_max_pool(two_stage=True)``,
``ResNet(pool_two_stage=True)``), ``isp.STAGE_NAMES`` and
``isp.default_camera_params``, against the JAX package's, on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu import isp as jisp
from raw2logit_tpu.models import resnet as jresnet

from raw2logit_tpu_torch import isp
from raw2logit_tpu_torch.models import resnet
from test_torch_staged import one_torch_thread  # noqa: F401

SHAPES = [(4, 8, 16, 16), (2, 16, 64, 48), (2, 3, 10, 14), (2, 3, 9, 12),
          (1, 2, 7, 7)]


def planes(shape, seed=0, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed),
                       dtype=torch.float32).to(dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_two_stage_pool_is_bitwise_the_3x3_pool(shape):
    """Value and gradient bitwise the 3x3/2 pool's (random float32 planes:
    every window's maximum unique); odd H or W take the 3x3 pool, as in
    JAX."""
    x = planes(shape).requires_grad_(True)
    g = planes((shape[0], shape[1], (shape[2] + 1) // 2,
                (shape[3] + 1) // 2), seed=1)
    out = {}
    for two_stage in (False, True):
        y = resnet.stem_max_pool(x, two_stage)
        (dx,) = torch.autograd.grad(y, x, g)
        out[two_stage] = y, dx
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_two_stage_pool_matches_jax(shape):
    """The port's two-stage pool (NCHW) equals JAX's
    ``stem_max_pool(two_stage=True)`` (NHWC) bitwise, in float32 and in
    bfloat16, whose ties leave the value alone."""
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        x = planes(shape, seed=2, dtype=dtype)
        got = resnet.stem_max_pool(x, two_stage=True).float().numpy()
        want = jresnet.stem_max_pool(
            jnp.asarray(x.float().permute(0, 2, 3, 1).numpy(), jdtype),
            two_stage=True)
        np.testing.assert_array_equal(
            got, np.transpose(np.asarray(want, np.float32), (0, 3, 1, 2)))


def test_resnet_pool_two_stage_trains_as_the_3x3_pool():
    """``ResNet(pool_two_stage=True)`` from the same weights: logits,
    every gradient and running statistic of a train-mode step bitwise the
    default ResNet's; the state dicts have the same keys."""
    x = planes((2, 3, 32, 32), seed=3)
    out = {}
    for two_stage in (False, True):
        net = resnet.ResNet(stage_sizes=(1, 1), num_filters=8,
                            num_classes=3, device="cpu",
                            pool_two_stage=two_stage).train()
        logits = net(x)
        logits.square().sum().backward()
        out[two_stage] = (logits.detach(),
                          {n: p.grad for n, p in net.named_parameters()},
                          net.state_dict())
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert torch.equal(l1, l0)
    for name, g in g0.items():
        assert torch.equal(g1[name], g), name
    assert s1.keys() == s0.keys()
    for name, t in s0.items():
        assert torch.equal(s1[name], t), name


def test_stage_names_and_default_camera_match_jax():
    assert isp.STAGE_NAMES == jisp.STAGE_NAMES
    got, want = isp.default_camera_params(), jisp.default_camera_params()
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
