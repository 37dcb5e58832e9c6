"""PyTorch port vs the JAX package: bfloat16 train steps.

JAX's bfloat16 step contract (``tests/test_bf16_parity.py:87-116``): the
microscopy ISP in float32 before a bfloat16 ResNet-18 (9 classes), 16
seeded 64x64 mosaics, lr 1e-3, three steps of ``make_train_step``; each
step's loss within 5% of the float32 step's. The port's three bfloat16
steps (``resnet_model(dtype=torch.bfloat16)``, the ISP float32) start
from JAX's initial weights (``convert.py``) and are held within 5% of
JAX's bfloat16 steps and of the port's own float32 steps; the parameters
and Adam's state stay float32.

Measured on the CPU: the port's bfloat16 losses 0.03-0.25% from JAX's
bfloat16 ones and 0.02-0.98% from the port's float32 ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.data.datasets import MICROSCOPY_CAMERA_PARAMS
from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.models import resnet_model as jax_resnet_model
from raw2logit_tpu.training import core as jcore

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.models import resnet_model
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401

N_CLASSES, BATCH, SIZE, STEPS, LR = 9, 16, 64, 3, 1e-3
LOSS_REL = 0.05


@pytest.fixture(scope="module")
def runs():
    """Losses of JAX's bfloat16 steps and of the port's bfloat16 and
    float32 steps from the same initial weights, and the port's bfloat16
    classifier and optimizer after them."""
    rng = np.random.default_rng(2)
    raw = rng.uniform(size=(BATCH, SIZE, SIZE)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, size=(BATCH,))
    cfg = jcore.TrainConfig(task="classification", lr=LR)
    proc = JaxProcessing(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                         image_size=SIZE)
    net = jax_resnet_model("resnet18", fc_out_features=N_CLASSES,
                           dtype=jnp.bfloat16)
    state, tx = jcore.create_train_state(cfg, proc, net, jnp.asarray(raw),
                                         jax.random.key(0))
    init = jax.device_get((state.proc_params, state.proc_stats,
                           state.clf_params, state.clf_stats))
    step = jcore.make_train_step(cfg, proc, net, tx)
    out = {"jax": []}
    for i in range(STEPS):
        state, mets = step(state, jnp.asarray(raw), jnp.asarray(y, jnp.int32),
                           jax.random.fold_in(jax.random.key(3), i))
        out["jax"].append(float(mets["loss"]))
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        p = ParametrizedProcessing(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                                   device="cpu")
        p.load_state_dict(convert.isp_state_dict(
            {"params": init[0], "batch_stats": init[1]}))
        clf = resnet_model("resnet18", fc_out_features=N_CLASSES,
                           dtype=dtype, device="cpu")
        clf.load_state_dict(convert.resnet_state_dict(
            {"params": init[2], "batch_stats": init[3]}))
        pcfg = TrainConfig(task="classification", lr=LR)
        st = create_train_state(pcfg, p, clf)
        port_step = make_train_step(pcfg, p, clf)
        out[name] = [float(port_step(st, torch.tensor(raw),
                                     torch.tensor(y))["loss"])
                     for _ in range(STEPS)]
        out[f"{name}_state"] = st
    return out


@pytest.mark.parametrize("against", ["jax", "f32"])
def test_bf16_step_losses_within_contract(runs, against):
    for got, want in zip(runs["bf16"], runs[against]):
        assert np.isfinite(got)
        assert abs(got - want) / max(abs(want), 1e-6) < LOSS_REL, runs


def test_bf16_step_keeps_parameters_and_adam_state_float32(runs):
    """flax's param_dtype: the bfloat16 model's parameters, running
    statistics, gradients and Adam moments stay float32."""
    state = runs["bf16_state"]
    for t in state.classifier.state_dict().values():
        assert not t.is_floating_point() or t.dtype == torch.float32
    for p in state.classifier.parameters():
        assert p.grad.dtype == torch.float32
        for v in state.optimizer.state[p].values():
            assert not v.is_floating_point() or v.dtype == torch.float32
