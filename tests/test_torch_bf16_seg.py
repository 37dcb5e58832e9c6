"""PyTorch port vs the JAX package: the bfloat16 U-Net++.

A small U-Net++ (resnet18 encoder, depth 3, decoder (16, 8, 4), one
class: the segmentation step's model of ``test_torch_unetpp.py``) in
bfloat16, on JAX's weights: its forward in eval and train mode against
flax's bfloat16 forward under JAX's bfloat16 drift contract
(``tests/test_bf16_parity.py``: per image, the largest logit difference
over the image's logit spread, median < 2%, max < 10%), its logits
float32 (the head computes in float32); and one segmentation train step
(the drone ISP in float32 -> the bfloat16 U-Net++ -> Dice -> Adam) whose
loss is within 5% of JAX's bfloat16 step and of the port's float32 step.
The adversarial step with a bfloat16 classifier is in
``test_torch_bf16_adversarial.py``.

All on the CPU at 64x64, B = 2. Measured on the CPU: drift from flax's
bfloat16 logits 0.56% median and 0.57% max in eval mode, 1.57% and 1.66%
in train mode (there each framework's bfloat16 reads 1.2-1.3% from its
own float32, and the two float32 forwards agree within 4e-6); the step's
loss 0.007% from JAX's bfloat16 step and 0.011% from the port's float32
one.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.models import unetpp as junetpp
from raw2logit_tpu.training import core as jcore

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.data import SyntheticRawSegmentation
from raw2logit_tpu_torch.models import unetpp
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from test_torch_isp import DRONE_CAM, jax_variables, port_processing
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401
from test_torch_stem_bf16_resnet import drift

SIZE, LR, LOSS_REL = 64, 1e-3, 0.05
DRIFT_MEDIAN, DRIFT_MAX = 0.02, 0.10
UNET = dict(encoder_name="resnet18", encoder_depth=3,
            decoder_channels=(16, 8, 4), classes=1)


def random_variables(model, x_shape, rng):
    """flax variables of ``model`` as numpy, drawn as
    ``test_torch_unetpp.random_variables`` draws them (the tree from
    ``jax.eval_shape``, so that no flax init runs)."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), jnp.zeros(x_shape))

    def leaf(path, s):
        kind = path[-1].key
        if kind == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])),
                           s.shape)
        elif kind == "scale":
            a = rng.uniform(0.5, 1.5, s.shape)
        elif kind == "var":
            a = rng.uniform(0.5, 2.0, s.shape)
        else:  # bias, mean
            a = rng.normal(0.0, 0.1, s.shape)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_cfg(cfg):
    return jcore.TrainConfig(**dataclasses.asdict(cfg))


def jax_loss(cfg, proc, clf, pv, cv, raw, y, ref_params=None):
    """One JAX ``make_train_step`` from ``pv``, ``cv``: its metrics."""
    state, tx = jcore.create_train_state(
        jax_cfg(cfg), proc, clf, jnp.asarray(raw), jax.random.key(0),
        processor_variables=pv, classifier_variables=cv)
    if ref_params is not None:  # the attacked processor
        state = state.replace(proc_params=jax.tree_util.tree_map(
            jnp.asarray, ref_params))
    step = jcore.make_train_step(jax_cfg(cfg), proc, clf, tx, donate=False)
    _, mets = step(state, jnp.asarray(raw), jnp.asarray(y),
                   jax.random.key(2))
    return {k: float(v) for k, v in jax.device_get(mets).items()}


# --- U-Net++ -----------------------------------------------------------------

@functools.cache
def seg_setup():
    """JAX variables of the drone ISP and the U-Net++, mosaics and masks."""
    rng = np.random.default_rng(11)
    pv = jax_variables(DRONE_CAM, rng, perturb=True)
    uv = random_variables(junetpp.UNetPlusPlus(**UNET), (1, SIZE, SIZE, 3),
                          rng)
    ds = SyntheticRawSegmentation(n=2, h=SIZE, w=SIZE, seed=4)
    raw = np.stack([ds[i][0] for i in range(2)])
    masks = np.stack([ds[i][1] for i in range(2)])
    return pv, uv, raw, masks


def port_unet(uv, dtype):
    model = unetpp.UNetPlusPlus(**UNET, device="cpu", dtype=dtype)
    model.load_state_dict(convert.unetpp_state_dict(uv))
    return model


@functools.cache
def jax_forwards():
    """flax's bfloat16 U-Net++ logits in eval and train mode (one jit) on
    a seeded batch, and the batch (NHWC)."""
    _, uv, _, _ = seg_setup()
    x = np.random.default_rng(1).normal(size=(2, SIZE, SIZE, 3)).astype(
        np.float32)
    net = junetpp.UNetPlusPlus(**UNET, dtype=jnp.bfloat16)
    both = jax.jit(lambda v, x: [
        net.apply(v, x, train=t, mutable=["batch_stats"])[0]
        for t in (False, True)])(uv, jnp.asarray(x))
    return [np.asarray(a) for a in both], x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unetpp_bf16_forward_matches_jax(train):
    _, uv, _, _ = seg_setup()
    wants, x = jax_forwards()
    want = wants[int(train)]
    model = port_unet(uv, torch.bfloat16).train(train)
    with torch.no_grad():
        got = model(torch.tensor(np.transpose(x, (0, 3, 1, 2))))
    assert got.dtype == torch.float32
    med, mx, _ = drift(got.numpy().reshape(2, -1),
                       np.transpose(np.asarray(want), (0, 3, 1, 2))
                       .reshape(2, -1))
    assert med < DRIFT_MEDIAN and mx < DRIFT_MAX, (med, mx)


@pytest.fixture(scope="module")
def seg_losses():
    pv, uv, raw, masks = seg_setup()
    cfg = TrainConfig(task="segmentation", lr=LR)
    out = {"jax": jax_loss(cfg, JaxProcessing(camera_parameters=DRONE_CAM),
                           junetpp.UNetPlusPlus(**UNET, dtype=jnp.bfloat16),
                           pv, uv, raw, masks)}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        proc, model = port_processing(pv), port_unet(uv, dtype)
        state = create_train_state(cfg, proc, model)
        mets = make_train_step(cfg, proc, model)(
            state, torch.tensor(raw), torch.tensor(masks))
        out[name] = {k: float(v) for k, v in mets.items()}
    return out


@pytest.mark.parametrize("against", ["jax", "f32"])
def test_unetpp_bf16_step_loss_within_contract(seg_losses, against):
    got, want = seg_losses["bf16"]["loss"], seg_losses[against]["loss"]
    assert np.isfinite(got)
    assert abs(got - want) / abs(want) < LOSS_REL, seg_losses
