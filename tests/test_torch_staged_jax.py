"""The port's staged train step against the JAX package's
``make_staged_train_step`` on the CPU: the plain processor, the fused-ISP
processor (JAX's fast staged path, its Pallas kernels in interpret mode),
``fuse_opt``, and the SSIM-regularised attack. Weights go from JAX to the
port through ``raw2logit_tpu_torch.convert``; the narrow ResNet and the
B = 4, 64x64 batch of tests/test_torch_train.py at its tolerances (the
attack at 32x32, as tests/test_torch_adversarial.py runs JAX's kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.training import core as jcore

from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_staged_train_step)
from test_torch_adversarial import (adv_config, attacked, narrow_jax_resnet,
                                    port_adv_setup)
from test_torch_isp import MILD_CAM, rel_err
from test_torch_staged import one_torch_thread  # noqa: F401
from test_torch_train import (GRAD_FLOOR, GRAD_TOL, LOSS_TOL, as_port,
                              batch, check_params, check_stats,  # noqa: F401
                              jax_config, jax_modules, port_modules, weights)

LR = 1e-3
SIZE = 32


def jax_staged_run(cfg, weights, raw, y, use_kernel, fuse_opt, monkeypatch):
    """JAX ``make_staged_train_step``, one step: (new state, metrics, the
    step's gradients by ``jax.grad`` of the one step's loss, through the
    jnp backward). With ``use_kernel`` the staged step then runs the
    Pallas backward (``R2L_FUSED_BWD=pallas``, interpreted)."""
    jcfg = jax_config(cfg)
    raw, y = jnp.asarray(raw), jnp.asarray(y, jnp.int32)
    proc, clf = jax_modules(use_kernel)
    state, tx = jcore.create_train_state(
        jcfg, proc, clf, raw, jax.random.key(0),
        processor_variables=weights[0], classifier_variables=weights[1],
        split_opt=fuse_opt)
    key = jax.random.key(2)

    def loss_fn(trainable):
        logits = jcore._forward(jcfg, proc, clf, trainable[0],
                                state.proc_stats, trainable[1],
                                state.clf_stats, raw, key, True)[0]
        return jcore.task_loss_fn(jcfg)(logits, y)

    grads = jax.jit(jax.grad(loss_fn))((state.proc_params, state.clf_params))
    if use_kernel:  # the staged fast path: the Pallas kernels, interpreted
        monkeypatch.setenv("R2L_FUSED_BWD", "pallas")
    step = jcore.make_staged_train_step(jcfg, proc, clf, tx, donate=False,
                                        fuse_opt=fuse_opt)
    state, mets = step(state, raw, y, key)
    return jax.device_get(state), jax.device_get(mets), jax.device_get(grads)


JAX_CASES = {"plain": (False, False), "kernel": (True, False),
             "fuse_opt": (False, True)}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_staged_step_matches_jax_staged(case, weights, batch, monkeypatch):
    """The port's staged step against JAX's, one step from the same
    weights (``convert.py``) and batch: loss, accuracy, gradients, running
    statistics and updated parameters at the tolerances of
    tests/test_torch_train.py. The kernel case runs JAX's fast staged path
    (residual planes handed to the Pallas backward) in interpret mode."""
    use_kernel, fuse_opt = JAX_CASES[case]
    monkeypatch.setenv("R2L_FUSED_BWD", "jnp")
    raw, y = batch
    cfg = TrainConfig(lr=LR)
    jstate, jmets, jgrads = jax_staged_run(cfg, weights, raw, y, use_kernel,
                                           fuse_opt, monkeypatch)
    proc, clf = port_modules(weights, use_kernel)
    state = create_train_state(cfg, proc, clf, split_opt=fuse_opt)
    mets = make_staged_train_step(cfg, proc, clf, fuse_opt=fuse_opt)(
        state, torch.from_numpy(raw), torch.from_numpy(y))
    assert abs(float(mets["loss"]) - float(jmets["loss"])) < LOSS_TOL
    assert float(mets["accuracy"]) == float(jmets["accuracy"])
    grads = {"proc": as_port(jgrads[0], {}, "proc"),
             "clf": as_port(jgrads[1], {}, "clf")}
    want = {"proc": as_port(jstate.proc_params, jstate.proc_stats, "proc"),
            "clf": as_port(jstate.clf_params, jstate.clf_stats, "clf")}
    for which, module in (("proc", proc), ("clf", clf)):
        for name, p in module.named_parameters():
            assert rel_err(p.grad, grads[which][name]) < GRAD_TOL, name
        check_stats(module, want[which])
        check_params(module, want[which], grads[which], 2 * LR)


def test_adversarial_staged_step_matches_jax_staged(weights, batch,
                                                    monkeypatch):
    """The SSIM-regularised attack through both staged steps: JAX's fast
    path (its Pallas ISP, residual backward and SSIM aux kernels,
    interpreted) and the port's (``ssim_aux_value_grad``): loss, aux value
    and the updated ISP parameters, as
    tests/test_torch_adversarial.py holds the one step to it."""
    monkeypatch.setenv("R2L_FUSED_BWD", "pallas")
    raw, y = batch[0][:, :SIZE, :SIZE].copy(), batch[1]
    ref_v = weights[0]
    adv_v = attacked(ref_v, np.random.default_rng(12))
    cfg = adv_config("ssim", "all")
    jcfg = jax_config(cfg)
    proc = JaxProcessing(camera_parameters=MILD_CAM, use_pallas=True,
                         image_size=SIZE)
    clf = narrow_jax_resnet()
    jstate, tx = jcore.create_train_state(
        jcfg, proc, clf, jnp.asarray(raw), jax.random.key(0),
        processor_variables=ref_v, classifier_variables=weights[1])
    jstate = jstate.replace(proc_params=jax.tree_util.tree_map(
        jnp.asarray, adv_v["params"]))
    jstate, jmets = jcore.make_staged_train_step(
        jcfg, proc, clf, tx, donate=False)(
        jstate, jnp.asarray(raw), jnp.asarray(y, jnp.int32),
        jax.random.key(1))

    proc, clf, state = port_adv_setup(cfg, ref_v, adv_v, weights[1], True,
                                      False, SIZE)
    mets = make_staged_train_step(cfg, proc, clf)(
        state, torch.from_numpy(raw), torch.from_numpy(y))
    scale = max(1.0, abs(float(jmets["loss"])))
    assert abs(float(mets["loss"]) - float(jmets["loss"])) <= LOSS_TOL * scale
    assert abs(float(mets["loss_aux"]) - float(jmets["loss_aux"])) <= 1e-6
    want = as_port(jax.device_get(jstate.proc_params), {}, "proc")
    for name, p in proc.named_parameters():
        limit = torch.where(p.grad.abs() < GRAD_FLOOR, 2 * LR, 1e-6)
        err = (p.detach() - want[name]).abs()
        assert bool((err <= limit).all()), (name, float(err.max()))
