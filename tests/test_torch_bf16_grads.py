"""PyTorch port vs the JAX package: the bfloat16 step's gradients.

The step of ``test_torch_bf16_steps.py`` (JAX's bfloat16 step contract,
``tests/test_bf16_parity.py:87-116``: the microscopy ISP in float32
before a bfloat16 ResNet-18 of 9 classes, 16 seeded 64x64 mosaics), its
first step's gradients held leaf by leaf to JAX's: every parameter of
the ISP and the ResNet-18, relative L2, the worst leaf within GRAD_REL.
Every leaf that is not zero is nearer JAX's bfloat16 gradient than the
port's float32 gradient is, and the float32 gradients exceed GRAD_REL, so
a backward that skipped bfloat16's rounding, or scaled a leaf's
gradient, fails. The model is JAX's as built: the last BN of every block
starts at zero scale, which leaves 32 of the 69 leaves at exactly zero
(compared exactly). With those scales set to 0.5-1.5 the step is too
ill-conditioned for bfloat16: the port's bfloat16 and float32 gradients
then read equally far from JAX's bfloat16 ones (median leaf ratio 0.96,
the ISP's gamma 111% against 60%), so no leaf-by-leaf bound separates
them there.

JAX's gradients are compiled with ``xla_allow_excess_precision`` off. By
default XLA:CPU drops bfloat16 roundings that the program writes (a
convert to bfloat16 and back), which the port, mirroring flax's program
layer by layer, keeps: with them dropped the port's bfloat16 gradients
read further from JAX's (median leaf 0.66%) than its float32 ones do
(0.51%). The worst leaves are the ill-conditioned ones, the ISP's
filters and the biases of the BNs whose cotangents cancel: the port's
float32 gradients read up to 1.3% from JAX's float32 ones there.

The whole step is a weak witness: it passes with the BNs' bfloat16 output
left in float32, or the convs' weight gradients scaled by 1.03, which
the block VJPs of ``test_torch_bf16_block.py`` fail.

Measured on the CPU: the port's bfloat16 gradients 9.3% on the worst leaf
(the ISP's sharpening filter) from JAX's bfloat16 ones, the port's
float32 gradients 19.6%; leaf by leaf, the bfloat16 distance is 0.50 of
the float32 one at the median and 0.88 at most (the ISP's black level).
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
from test_torch_bf16_steps import BATCH, LR, N_CLASSES, SIZE
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401

# the worst leaf's relative L2 against JAX's bfloat16 gradients (measured
# 9.3%; the port's float32 gradients read 19.6%)
GRAD_REL = 0.12


def jax_first_step_grads(cfg, proc, net, state, raw, y):
    """JAX's gradients of the first step's loss (``make_train_step``'s:
    the ISP in train mode, the task loss, no augmentation), rounding where
    the program says."""
    loss_of = jcore.task_loss_fn(cfg)

    def loss_fn(trainable):
        logits = jcore._forward(cfg, proc, net, trainable[0],
                                state.proc_stats, trainable[1],
                                state.clf_stats, raw, jax.random.key(3),
                                train=True)[0]
        return loss_of(logits, y)

    trainable = (state.proc_params, state.clf_params)
    return jax.device_get(jax.jit(jax.grad(loss_fn)).lower(trainable).compile(
        {"xla_allow_excess_precision": False})(trainable))


@pytest.fixture(scope="module")
def grads():
    """{"jax" | "bf16" | "f32": {"isp.<name>" | "clf.<name>": gradient}}:
    JAX's bfloat16 first-step gradients under the port's names, and the
    port's bfloat16 and float32 ones from the same initial weights."""
    rng = np.random.default_rng(2)
    raw = rng.uniform(size=(BATCH, SIZE, SIZE)).astype(np.float32)
    y = rng.integers(0, N_CLASSES, size=(BATCH,))
    cfg = jcore.TrainConfig(task="classification", lr=LR)
    proc = JaxProcessing(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                         image_size=SIZE)
    net = jax_resnet_model("resnet18", fc_out_features=N_CLASSES,
                           dtype=jnp.bfloat16)
    state, _ = jcore.create_train_state(cfg, proc, net, jnp.asarray(raw),
                                        jax.random.key(0))
    pvars = {"params": jax.device_get(state.proc_params),
             "batch_stats": jax.device_get(state.proc_stats)}
    cvars = {"params": jax.device_get(state.clf_params),
             "batch_stats": jax.device_get(state.clf_stats)}
    g_proc, g_clf = jax_first_step_grads(cfg, proc, net, state,
                                         jnp.asarray(raw),
                                         jnp.asarray(y, jnp.int32))
    out = {"jax": {
        **{f"isp.{n}": t for n, t in convert.isp_state_dict(
            {"params": g_proc}).items()},
        **{f"clf.{n}": t for n, t in convert.resnet_state_dict(
            {"params": g_clf}).items()}}}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        p = ParametrizedProcessing(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                                   device="cpu")
        p.load_state_dict(convert.isp_state_dict(pvars))
        clf = resnet_model("resnet18", fc_out_features=N_CLASSES,
                           dtype=dtype, device="cpu")
        clf.load_state_dict(convert.resnet_state_dict(cvars))
        pcfg = TrainConfig(task="classification", lr=LR)
        make_train_step(pcfg, p, clf)(create_train_state(pcfg, p, clf),
                                      torch.tensor(raw), torch.tensor(y))
        out[name] = {f"{side}.{n}": t.grad
                     for side, m in (("isp", p), ("clf", clf))
                     for n, t in m.named_parameters()}
    return out


def leaf_rel(got, want):
    """{leaf: ||got - want|| / ||want||}."""
    return {n: float((g.double() - want[n].double()).norm()
                     / want[n].double().norm().clamp_min(1e-30))
            for n, g in got.items()}


def test_bf16_first_step_gradients_leaf_by_leaf(grads):
    """Every leaf that JAX's gradient leaves at exactly zero (the residual
    branches behind the zero-scale BNs of the as-built ResNet) is exactly
    zero; every other leaf is nearer JAX's bfloat16 gradient than the
    port's float32 gradient is (measured: at most 0.88 of its distance),
    and the worst within GRAD_REL."""
    want = grads["jax"]
    got, f32 = (leaf_rel(grads[k], want) for k in ("bf16", "f32"))
    assert set(got) == set(want), sorted(got)
    assert all(g.dtype == torch.float32 for g in grads["bf16"].values())
    zero = {n for n, t in want.items() if not t.any()}
    assert all(not grads["bf16"][n].any() for n in zero)
    assert len(zero) < len(want) / 2
    nearer = {n: (got[n], f32[n]) for n in want if n not in zero
              and not got[n] < f32[n]}
    assert not nearer, nearer
    worst = max(got.items(), key=lambda kv: kv[1])
    worst_f32 = max(f32.items(), key=lambda kv: kv[1])
    assert worst[1] < GRAD_REL < worst_f32[1], (worst, worst_f32)

