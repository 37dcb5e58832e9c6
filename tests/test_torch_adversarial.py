"""PyTorch port vs the JAX package: the adversarial (drift-forensics)
train step, its eval step, and a checkpoint that carries the frozen
reference processor.

All on the CPU, with the narrow-ResNet fixtures of
tests/test_torch_train.py (B = 4, 64x64). The processor under attack
starts from a seeded perturbation of the reference processor (as after
``--processor_uri``), so that the aux term and its gradient are not at
their optimum. Cases cover the SSIM and l2 aux losses and the targets
'all', 'gamma_correct' and 'additive_layer' (with the noise layer), on the
plain and the fused-kernel processor (whose wrappers run their plain
versions here); one case holds the port's step to the JAX staged step,
whose fast path runs the Pallas fused-ISP and SSIM aux kernels in
interpret mode.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu import losses as jlosses
from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.models import resnet as jresnet
from raw2logit_tpu.training import core as jcore

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.models import resnet
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_eval_step, make_train_step)
from raw2logit_tpu_torch.training.checkpoint import restore_state, save_state
from test_torch_isp import MILD_CAM, port_processing, rel_err
from test_torch_train import (GRAD_FLOOR, GRAD_TOL, LOSS_TOL, PARAM_TOL,
                              batch, weights)  # noqa: F401 (fixtures)

LR = 1e-3
AUX_WEIGHT = -0.7
# aux value: SSIM 1e-6 abs (tests/test_pallas.py:231); l2, a sum of
# B*3*H*W squared differences (~4e2 here), 1e-6 relative. The loss, which
# carries the aux value, at LOSS_TOL relative to max(1, |loss|).
AUX_TOL = {"ssim": 1e-6, "l2": 1e-6}


def close(got, want, tol):
    """|got - want| <= tol * max(1, |want|)."""
    return abs(float(got) - float(want)) <= tol * max(1.0, abs(float(want)))

# seeded perturbation of the attacked processor against the reference
ATTACK = {"black_level": 1e-3, "white_balance": 0.02,
          "colour_correction": 0.02, "gamma_correct": 0.05,
          "sharpening_filter": 0.02, "gaussian_blur": 0.005,
          "debayer": 0.02, "additive_layer": 0.02}

CASES = {
    "ssim-all-plain": ("ssim", "all", False),
    "ssim-gamma-kernel": ("ssim", "gamma_correct", True),
    "ssim-additive-kernel": ("ssim", "additive_layer", True),
    "l2-all-kernel": ("l2", "all", True),
}


def adv_config(aux, target):
    return TrainConfig(lr=LR, adv_training=True, freeze_classifier=True,
                       loss_weight=-1.0, adv_aux_loss=aux,
                       adv_aux_weight=AUX_WEIGHT, adv_parameters=target)


def with_noise_layer(pv, size, rng):
    """JAX ISP variables with an additive layer (zero, as initialised)."""
    pv = copy.deepcopy(pv)
    pv["params"]["additive_layer"] = np.zeros((1, size, size, 3),
                                              np.float32)
    return pv


def attacked(pv, rng):
    """The reference variables with every parameter perturbed."""
    pv = copy.deepcopy(pv)
    for k, a in pv["params"].items():
        pv["params"][k] = (a + rng.normal(0.0, ATTACK[k], a.shape)).astype(
            np.float32)
    return pv


def narrow_jax_resnet():
    return jresnet.ResNet(block_cls=jresnet.BasicBlock,
                          stage_sizes=(1, 1, 1, 1), num_filters=8,
                          num_classes=2)


def jax_adv_run(cfg, ref_v, adv_v, cv, raw, y, use_kernel, noise):
    """JAX ``make_train_step``, one step from the reference ``ref_v`` with
    the attacked processor ``adv_v``: (new state, metrics, ISP gradients)."""
    jcfg = jcore.TrainConfig(**dataclasses.asdict(cfg))
    proc = JaxProcessing(camera_parameters=MILD_CAM, use_pallas=use_kernel,
                         additive_layer=noise, image_size=raw.shape[-1])
    clf = narrow_jax_resnet()
    raw, y = jnp.asarray(raw), jnp.asarray(y, jnp.int32)
    state, tx = jcore.create_train_state(
        jcfg, proc, clf, raw, jax.random.key(0), processor_variables=ref_v,
        classifier_variables=cv)
    state = state.replace(proc_params=jax.tree_util.tree_map(
        jnp.asarray, adv_v["params"]))
    key = jax.random.key(2)
    aux_fn = jlosses.aux_loss(jcfg.adv_aux_loss, jcfg.adv_aux_weight)

    @jax.jit
    def grads(state):
        def loss_fn(pp):
            logits, rgb = jcore._forward(jcfg, proc, clf, pp,
                                         state.proc_stats, state.clf_params,
                                         state.clf_stats, raw, key, True)[:2]
            ref_rgb, _ = proc.apply({"params": state.ref_proc_params,
                                     "batch_stats": state.ref_proc_stats},
                                    raw, train=False)
            return (jcore.task_loss_fn(jcfg)(logits, y)
                    + aux_fn(ref_rgb, rgb))
        return jax.grad(loss_fn)(state.proc_params)

    g = grads(state)
    new_state, mets = jcore.make_train_step(jcfg, proc, clf, tx,
                                            donate=False)(state, raw, y, key)
    return jax.device_get(new_state), jax.device_get(mets), jax.device_get(g)


def port_adv_setup(cfg, ref_v, adv_v, cv, use_kernel, noise, size):
    """The port's modules and state: the reference processor from
    ``ref_v``, then the attacked weights loaded into the processor."""
    proc = port_processing(ref_v, use_kernel=use_kernel, additive_layer=noise,
                           image_size=size)
    clf = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                        num_classes=2, device="cpu")
    clf.load_state_dict(convert.resnet_state_dict(cv))
    state = create_train_state(cfg, proc, clf)
    proc.load_state_dict(convert.isp_state_dict(adv_v))
    return proc, clf, state


def snapshot(module):
    return {k: v.clone() for k, v in module.state_dict().items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adversarial_step_matches_jax(case, weights, batch):
    aux, target, use_kernel = CASES[case]
    noise = target == "additive_layer"
    rng = np.random.default_rng(11)
    ref_v = with_noise_layer(weights[0], 64, rng) if noise else weights[0]
    adv_v = attacked(ref_v, rng)
    cfg = adv_config(aux, target)
    jstate, jmets, jgrads = jax_adv_run(cfg, ref_v, adv_v, weights[1],
                                        batch[0], batch[1], use_kernel, noise)

    proc, clf, state = port_adv_setup(cfg, ref_v, adv_v, weights[1],
                                      use_kernel, noise, 64)
    before = snapshot(proc)
    clf_before, ref_before = snapshot(clf), snapshot(state.ref_processor)
    mets = make_train_step(cfg, proc, clf)(
        state, torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    assert close(mets["loss"], jmets["loss"], LOSS_TOL)
    assert close(mets["loss_aux"], jmets["loss_aux"], AUX_TOL[aux])
    assert float(mets["accuracy"]) == float(jmets["accuracy"])

    want_grads = convert.isp_state_dict({"params": jgrads})
    want = convert.isp_state_dict({"params": jstate.proc_params})
    for name, p in proc.named_parameters():
        if target != "all" and target not in name:
            assert p.grad is None and not p.requires_grad, name
            assert torch.equal(p.detach(), before[name]), name
            continue
        assert rel_err(p.grad, want_grads[name]) < GRAD_TOL, (
            name, rel_err(p.grad, want_grads[name]))
        limit = np.where(np.abs(want_grads[name].numpy()) < GRAD_FLOOR,
                         2 * LR, PARAM_TOL)
        err = np.abs(p.detach().numpy() - want[name].numpy())
        assert (err <= limit).all(), (name, float(err.max()))
        assert not torch.equal(p.detach(), before[name]), name
    # frozen: the classifier (weights and BN statistics), the processor's
    # BN statistics, the whole reference processor
    for module, start in ((clf, clf_before), (state.ref_processor,
                                              ref_before)):
        for name, t in module.state_dict().items():
            assert torch.equal(t, start[name]), name
    for name in ("batch_norm.running_mean", "batch_norm.running_var"):
        assert torch.equal(proc.state_dict()[name], before[name]), name
    assert not proc.training and not clf.training


def test_adversarial_step_matches_jax_staged_pallas(weights, batch,
                                                    monkeypatch):
    """The port's kernel-path step against the JAX staged step, whose fast
    path runs the Pallas fused ISP, its residual backward and the SSIM
    aux kernel (interpret mode), at 32x32 (tests/test_pallas.py:236-272):
    loss, aux value and the updated ISP parameters."""
    monkeypatch.setenv("R2L_FUSED_BWD", "pallas")
    raw, y = batch[0][:, :32, :32].copy(), batch[1]
    rng = np.random.default_rng(12)
    ref_v, adv_v = weights[0], attacked(weights[0], rng)
    cfg = adv_config("ssim", "all")
    jcfg = jcore.TrainConfig(**dataclasses.asdict(cfg))
    proc = JaxProcessing(camera_parameters=MILD_CAM, use_pallas=True,
                         image_size=32)
    clf = narrow_jax_resnet()
    state, tx = jcore.create_train_state(
        jcfg, proc, clf, jnp.asarray(raw), jax.random.key(0),
        processor_variables=ref_v, classifier_variables=weights[1])
    state = state.replace(proc_params=jax.tree_util.tree_map(
        jnp.asarray, adv_v["params"]))
    step = jcore.make_staged_train_step(jcfg, proc, clf, tx, donate=False)
    assert "aux_grad" in step.programs
    jstate, jmets = step(state, jnp.asarray(raw), jnp.asarray(y, jnp.int32),
                         jax.random.key(1))

    proc, clf, state = port_adv_setup(cfg, ref_v, adv_v, weights[1], True,
                                      False, 32)
    mets = make_train_step(cfg, proc, clf)(state, torch.from_numpy(raw),
                                           torch.from_numpy(y))
    assert close(mets["loss"], jmets["loss"], LOSS_TOL)
    assert close(mets["loss_aux"], jmets["loss_aux"], AUX_TOL["ssim"])
    want = convert.isp_state_dict({"params": jax.device_get(
        jstate.proc_params)})
    for name, p in proc.named_parameters():
        # Adam's first step moves a parameter by lr * sign(g): where the
        # gradient is near zero its sign may flip (test_torch_train.py)
        limit = torch.where(p.grad.abs() < GRAD_FLOOR, 2 * LR, PARAM_TOL)
        err = (p.detach() - want[name]).abs()
        assert bool((err <= limit).all()), (name, float(err.max()))


@pytest.mark.parametrize("aux", ["ssim", "l2"])
def test_adversarial_eval_step_matches_jax(aux, weights, batch):
    """The eval step adds the aux term to the validation loss and reports
    it as ``loss_aux``."""
    rng = np.random.default_rng(13)
    ref_v, adv_v = weights[0], attacked(weights[0], rng)
    cfg = adv_config(aux, "all")
    jcfg = jcore.TrainConfig(**dataclasses.asdict(cfg))
    proc = JaxProcessing(camera_parameters=MILD_CAM)
    clf = narrow_jax_resnet()
    state, _ = jcore.create_train_state(
        jcfg, proc, clf, jnp.asarray(batch[0]), jax.random.key(0),
        processor_variables=ref_v, classifier_variables=weights[1])
    state = state.replace(proc_params=jax.tree_util.tree_map(
        jnp.asarray, adv_v["params"]))
    jlogits, jmets = jcore.make_eval_step(jcfg, proc, clf)(
        state, jnp.asarray(batch[0]), jnp.asarray(batch[1], jnp.int32),
        jax.random.key(0))

    proc, clf, state = port_adv_setup(cfg, ref_v, adv_v, weights[1], False,
                                      False, 64)
    logits, mets = make_eval_step(cfg, proc, clf)(
        state, torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)
    assert close(mets["loss_aux"], jmets["loss_aux"], AUX_TOL[aux])
    assert close(mets["loss"], jmets["loss"], LOSS_TOL)


def test_checkpoint_carries_the_reference_processor(weights, batch,
                                                    tmp_path):
    """Save an adversarial state after a step and restore it into a state
    built from other weights: the reference processor comes back with the
    rest, and the next step is the uninterrupted run's."""
    rng = np.random.default_rng(14)
    ref_v, adv_v = weights[0], attacked(weights[0], rng)
    cfg = adv_config("ssim", "all")
    raw, y = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    proc, clf, state = port_adv_setup(cfg, ref_v, adv_v, weights[1], True,
                                      False, 64)
    step = make_train_step(cfg, proc, clf)
    step(state, raw, y)
    path = save_state(state, str(tmp_path / "adv.pt"))
    want = step(state, raw, y)

    proc2, clf2, state2 = port_adv_setup(cfg, adv_v, ref_v, weights[1], True,
                                         False, 64)
    assert not torch.equal(state2.ref_processor.gamma_correct,
                           state.ref_processor.gamma_correct)
    restore_state(path, state2)
    for (name, a), b in zip(state.ref_processor.state_dict().items(),
                            state2.ref_processor.state_dict().values()):
        assert torch.equal(a, b), name
    got = make_train_step(cfg, proc2, clf2)(state2, raw, y)
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["loss_aux"]) == float(want["loss_aux"])
