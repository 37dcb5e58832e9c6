"""PyTorch port vs the JAX package: the bfloat16 stem inside the ResNet.

``ResNet(stem_kernel=True,
dtype=torch.bfloat16)`` against the flax ResNet with ``stem_pallas=True``
and ``dtype=jnp.bfloat16`` on the same converted weights, in eval mode
(``stem_eval``) and train mode (``stem_train``, its running statistics
too), within JAX's bfloat16 logit contract (``tests/test_bf16_parity.py``):
drift < 2% median and < 10% max of each sample's logit spread, argmax
agreement >= 99%. A two-stage ResNet (64 filters, the stem kernels' width)
keeps JAX's interpret-mode compile short.

Measured on the CPU: logits drift at most 0.3% of the spread (eval and
train), argmax agreement 100%; running statistics within 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.models import resnet as jresnet

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.models import resnet
from test_torch_resnet import randomize
from test_torch_stem_bf16 import (  # noqa: F401 (one_torch_thread)
    one_torch_thread, widened_bf16_dots)

DRIFT_MEDIAN, DRIFT_MAX, ARGMAX_AGREE = 0.02, 0.10, 0.99
RUN_REL = 1e-5
STAGES = (1, 1)


def drift(got, want):
    """(median, max) over samples of max |got - want| / the sample's logit
    spread in ``want``, and the argmax agreement."""
    spread = want.max(1) - want.min(1)
    rel = np.abs(got - want).max(1) / np.maximum(spread, 1e-6)
    return (float(np.median(rel)), float(rel.max()),
            float(np.mean(got.argmax(1) == want.argmax(1))))


def assert_logit_contract(got, want):
    med, mx, agree = drift(got, want)
    assert med < DRIFT_MEDIAN and mx < DRIFT_MAX, (med, mx)
    assert agree >= ARGMAX_AGREE, agree


@pytest.fixture(scope="module")
def resnets():
    """The flax ResNet with the Pallas stem in bfloat16, its randomized
    variables, the port's with the stem kernel in bfloat16 on them, and a
    batch of 8 32x32 images (NHWC numpy)."""
    rng = np.random.default_rng(5)
    net = jresnet.ResNet(stage_sizes=STAGES, num_classes=9,
                         dtype=jnp.bfloat16, stem_pallas=True)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    variables = randomize(jresnet.ResNet(stage_sizes=STAGES, num_classes=9)
                          .init(jax.random.key(0), jnp.asarray(x),
                                train=False), rng)
    port = resnet.ResNet(stage_sizes=STAGES, num_classes=9, device="cpu",
                         stem_kernel=True, dtype=torch.bfloat16)
    port.load_state_dict(convert.resnet_state_dict(variables))
    return net, variables, port, x


def test_resnet_with_stem_kernel_eval_logits(resnets):
    net, variables, port, x = resnets
    with widened_bf16_dots():
        want = np.asarray(net.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port.eval()(torch.tensor(np.transpose(x, (0, 3, 1, 2))))
    assert got.dtype == torch.float32
    assert_logit_contract(got.numpy(), want)


def test_resnet_with_stem_kernel_train_logits_and_statistics(resnets):
    net, variables, port, x = resnets
    with widened_bf16_dots():
        want, mutated = net.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    with torch.no_grad():
        got = port.train()(torch.tensor(np.transpose(x, (0, 3, 1, 2))))
    assert_logit_contract(got.numpy(), np.asarray(want))
    bn = mutated["batch_stats"]["bn_init"]
    for key, buf in (("mean", port.bn1.running_mean),
                     ("var", port.bn1.running_var)):
        w = np.asarray(bn[key])
        assert np.abs(buf.numpy() - w).max() / np.abs(w).max() < RUN_REL
