"""PyTorch port vs the JAX package: the adversarial step with a bfloat16
frozen classifier.

The adversarial step of drift forensics (the microscopy ISP in float32
under attack, SSIM aux, every ISP parameter a target, the narrow ResNet
of ``test_torch_train.py`` frozen in bfloat16), one step from a seeded
perturbation of the reference processor, at B = 4, 64x64 on the CPU: the
loss and the aux value within 5% of JAX's bfloat16 step
(``tests/test_bf16_parity.py``'s loss contract) and of the port's float32
step. Measured on the CPU: the loss 0.025% from JAX's and 0.002% from
the port's float32 step, the aux value within 3e-7 of both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.models import resnet as jresnet

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.models import resnet
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from test_torch_bf16_seg import LOSS_REL, LR, SIZE, jax_loss, \
    random_variables
from test_torch_isp import MILD_CAM, jax_variables, port_processing
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def adv_losses():
    """One adversarial step (SSIM aux, all ISP parameters) against a frozen
    narrow ResNet in bfloat16: JAX's, the port's bfloat16 and float32
    metrics."""
    rng = np.random.default_rng(7)
    ref_v = jax_variables(MILD_CAM, rng, perturb=True)
    adv_params = {k: (a + rng.normal(0.0, 0.01, a.shape)).astype(np.float32)
                  for k, a in ref_v["params"].items()}
    narrow = dict(block_cls=jresnet.BasicBlock, stage_sizes=(1, 1, 1, 1),
                  num_filters=8, num_classes=2)
    cv = random_variables(jresnet.ResNet(**narrow), (1, SIZE, SIZE, 3), rng)
    raw = rng.uniform(0.2, 0.8, (4, SIZE, SIZE)).astype(np.float32)
    y = np.array([0, 1, 1, 0])
    cfg = TrainConfig(lr=LR, adv_training=True, freeze_classifier=True,
                      loss_weight=-1.0, adv_aux_loss="ssim",
                      adv_aux_weight=-0.7)
    out = {"jax": jax_loss(cfg, JaxProcessing(camera_parameters=MILD_CAM),
                           jresnet.ResNet(**narrow, dtype=jnp.bfloat16),
                           ref_v, cv, raw, y, ref_params=adv_params)}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        proc = port_processing(ref_v)
        clf = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                            num_classes=2, device="cpu", dtype=dtype)
        clf.load_state_dict(convert.resnet_state_dict(cv))
        state = create_train_state(cfg, proc, clf)
        proc.load_state_dict(convert.isp_state_dict(
            {"params": adv_params, "batch_stats": ref_v["batch_stats"]}))
        mets = make_train_step(cfg, proc, clf)(state, torch.tensor(raw),
                                               torch.tensor(y))
        out[name] = {k: float(v) for k, v in mets.items()}
    return out


@pytest.mark.parametrize("against", ["jax", "f32"])
@pytest.mark.parametrize("key", ["loss", "loss_aux"])
def test_adversarial_bf16_step_within_contract(adv_losses, against, key):
    got, want = adv_losses["bf16"][key], adv_losses[against][key]
    assert np.isfinite(got)
    assert abs(got - want) / abs(want) < LOSS_REL, adv_losses
