"""PyTorch port vs the JAX package: the ResNet's train-mode batch norm,
the losses and metrics, one train step (loss, gradients, updated
parameters and both modules' BN statistics), the cosine schedule, the
eval step, and the port's checkpoints.

All on the CPU, at a small size: B = 4, 64x64 mosaics, the ISP with its
output BN, and a narrow ResNet (8 filters, one block per stage). Weights
go from JAX to the port through ``raw2logit_tpu_torch.convert``.
"""

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

from raw2logit_tpu_torch import convert, losses
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.models import resnet
from raw2logit_tpu_torch.ops import constants
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_eval_step, make_train_step)
from raw2logit_tpu_torch.training.checkpoint import restore_state, save_state
from test_torch_isp import (MILD_CAM, jax_variables, port_processing,
                            rel_err)
from test_torch_resnet import randomize

LR = 1e-3
# one f32 step, two frameworks: loss abs; gradients inf-relative (the f32
# tier of tests/test_reference_parity.py); BN statistics relative;
# updated parameters abs. Adam's first step is lr * g / (|g| + 1e-8),
# which moves by lr * 1e-8 * dg / g^2 for a gradient error dg: with the
# frameworks' gradients ~3e-7 apart, that exceeds PARAM_TOL only below
# ~2e-6, and below GRAD_FLOOR a flipped sign costs up to 2 lr.
LOSS_TOL, GRAD_TOL, STATS_TOL, PARAM_TOL, GRAD_FLOOR = (
    1e-5, 2e-3, 1e-5, 1e-6, 1e-5)
# After three steps the classifier's parameters that crossed zero in step
# 1 have moved the later steps' activations: its parameters are held to
# a tenth of lr (a wrong schedule moves every step by >= lr / 4) and its
# statistics to 5e-3 relative. The ISP keeps the one-step tolerances.
STEPS_CLF_PARAM_TOL, STEPS_CLF_STATS_TOL = 1e-4, 5e-3
# running statistics of one train-mode forward (BN repair), relative to
# the largest: flax computes the batch variance as E[x^2] - E[x]^2. The
# bottleneck's six convs carry f32 conv rounding to 1.5e-6; the unbiased
# update differs by var / (n - 1) in the batch term, above 1e-4 of the
# statistic at every layer here, so both tolerances tell the rules apart.
BN_TOL = {"basic": 1e-6, "bottleneck": 1e-5}


def jax_config(cfg):
    return jcore.TrainConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def weights():
    """JAX variables of the ISP (perturbed, non-trivial BN statistics) and
    of the narrow ResNet (random BN scales and statistics), as numpy."""
    rng = np.random.default_rng(7)
    pv = jax_variables(MILD_CAM, rng, perturb=True)
    clf = jresnet.ResNet(block_cls=jresnet.BasicBlock,
                         stage_sizes=(1, 1, 1, 1), num_filters=8,
                         num_classes=2)
    cv = randomize(clf.init(jax.random.key(1), jnp.zeros((1, 64, 64, 3)),
                            train=False), rng)
    return pv, cv


@pytest.fixture(scope="module")
def batch():
    """Smoothed mosaics (B = 4, 64x64) that keep the ISP's output off the
    clip floor, where the gamma slope would amplify float32 rounding
    differences between the frameworks, and labels."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, (4, 68, 68))
    x = sum(x[:, i:i + 64, j:j + 64] for i in range(5) for j in range(5))
    x = 0.25 + 0.5 * (x - x.min()) / (x.max() - x.min())
    return x.astype(np.float32), np.array([0, 1, 1, 0])


def jax_modules(use_kernel):
    return (JaxProcessing(camera_parameters=MILD_CAM, use_pallas=use_kernel),
            jresnet.ResNet(block_cls=jresnet.BasicBlock,
                           stage_sizes=(1, 1, 1, 1), num_filters=8,
                           num_classes=2))


def port_modules(weights, use_kernel):
    pv, cv = weights
    proc = port_processing(pv, use_kernel=use_kernel)
    clf = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                        num_classes=2, device="cpu")
    clf.load_state_dict(convert.resnet_state_dict(cv))
    return proc, clf


def jax_run(cfg, weights, batch, use_kernel, steps=1):
    """JAX ``make_train_step`` for ``steps`` steps: (new state, metrics of
    each step, gradients of the first step)."""
    cfg = jax_config(cfg)
    raw, y = jnp.asarray(batch[0]), jnp.asarray(batch[1], jnp.int32)
    proc, clf = jax_modules(use_kernel)
    state, tx = jcore.create_train_state(
        cfg, proc, clf, raw, jax.random.key(0),
        processor_variables=weights[0], classifier_variables=weights[1])
    key = jax.random.key(2)

    @jax.jit
    def grads(state):
        def loss_fn(trainable):
            logits = jcore._forward(cfg, proc, clf, trainable[0],
                                    state.proc_stats, trainable[1],
                                    state.clf_stats, raw, key, True)[0]
            return jcore.task_loss_fn(cfg)(logits, y)
        return jax.grad(loss_fn)((state.proc_params, state.clf_params))

    g = grads(state)
    step = jcore.make_train_step(cfg, proc, clf, tx, donate=False)
    mets = []
    for _ in range(steps):
        state, m = step(state, raw, y, key)
        mets.append(jax.device_get(m))
    return jax.device_get(state), mets, jax.device_get(g)


def port_run(cfg, weights, batch, use_kernel, steps=1):
    proc, clf = port_modules(weights, use_kernel)
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    raw, y = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    mets, lrs = [], []
    for _ in range(steps):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        mets.append({k: float(v) for k, v in step(state, raw, y).items()})
    return state, mets, lrs


def as_port(jstate_params, jstate_stats, which):
    variables = {"params": jstate_params, "batch_stats": jstate_stats}
    return (convert.isp_state_dict(variables) if which == "proc"
            else convert.resnet_state_dict(variables))


def check_params(module, want, want_grads, slack, tol=PARAM_TOL):
    """Updated parameters within ``tol``, or ``slack`` where the JAX
    gradient is below GRAD_FLOOR."""
    for name, p in module.named_parameters():
        got = p.detach().numpy()
        limit = np.where(np.abs(want_grads[name].numpy()) < GRAD_FLOOR,
                         slack, tol)
        err = np.abs(got - want[name].numpy())
        assert (err <= limit).all(), (name, float(err.max()))


def check_stats(module, want, tol=STATS_TOL):
    for name, b in module.named_buffers():
        if "running" in name:
            assert rel_err(b, want[name]) < tol, (name,
                                                  rel_err(b, want[name]))


STEP_CASES = {
    "plain": (dict(), False),
    "weight_decay": (dict(weight_decay=1e-2), False),
    "freeze_classifier": (dict(freeze_classifier=True), False),
    "kernel": (dict(), True),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case, weights, batch):
    kwargs, use_kernel = STEP_CASES[case]
    cfg = TrainConfig(lr=LR, **kwargs)
    jstate, jmets, jgrads = jax_run(cfg, weights, batch, use_kernel)
    state, mets, _ = port_run(cfg, weights, batch, use_kernel)
    assert abs(mets[0]["loss"] - float(jmets[0]["loss"])) < LOSS_TOL
    assert mets[0]["accuracy"] == float(jmets[0]["accuracy"])
    assert state.step == 1

    proc_grads = as_port(jgrads[0], {}, "proc")
    for name, p in state.processor.named_parameters():
        assert rel_err(p.grad, proc_grads[name]) < GRAD_TOL, (
            name, rel_err(p.grad, proc_grads[name]))
    clf_grads = as_port(jgrads[1], {}, "clf")
    for name, p in state.classifier.named_parameters():
        if cfg.freeze_classifier:
            assert p.grad is None and not p.requires_grad
            continue
        assert rel_err(p.grad, clf_grads[name]) < GRAD_TOL, (
            name, rel_err(p.grad, clf_grads[name]))

    want_proc = as_port(jstate.proc_params, jstate.proc_stats, "proc")
    want_clf = as_port(jstate.clf_params, jstate.clf_stats, "clf")
    check_stats(state.processor, want_proc)
    check_stats(state.classifier, want_clf)
    # Adam sees the gradient plus the coupled decay wd * p
    before = port_modules(weights, use_kernel)
    for module, grads, start in ((state.processor, proc_grads, before[0]),
                                 (state.classifier, clf_grads, before[1])):
        start = start.state_dict()
        check_params(module, want_proc if module is state.processor
                     else want_clf,
                     {n: g + cfg.weight_decay * start[n]
                      for n, g in grads.items()}, 2 * LR)
    if cfg.freeze_classifier:  # eval mode: statistics and weights unchanged
        for name, t in state.classifier.state_dict().items():
            assert torch.equal(t, before[1].state_dict()[name]), name


def test_processor_instances_own_their_filters():
    """An optimizer step on one processor's filters leaves another
    processor, and the default kernels it starts from, unchanged."""
    a, b = (ParametrizedProcessing(device="cpu") for _ in range(2))
    k_sharp, k_blur = constants.K_SHARP.copy(), constants.K_BLUR.copy()
    with torch.no_grad():
        for p in a.parameters():
            p.add_(1.0)
    np.testing.assert_array_equal(constants.K_SHARP, k_sharp)
    np.testing.assert_array_equal(constants.K_BLUR, k_blur)
    for name, p in b.named_parameters():
        assert not torch.equal(p, dict(a.named_parameters())[name]), name


def test_cosine_schedule_three_steps(weights, batch):
    """Three steps with lr_schedule='cosine', total_steps=3: the port's
    learning rates are lr (1 + cos(pi k / 3)) / 2 for k = 0, 1, 2, and
    loss and weights follow the JAX steps."""
    cfg = TrainConfig(lr=LR, lr_schedule="cosine", total_steps=3)
    jstate, jmets, jgrads = jax_run(cfg, weights, batch, False, steps=3)
    state, mets, lrs = port_run(cfg, weights, batch, False, steps=3)
    np.testing.assert_allclose(
        lrs, [LR * (1 + np.cos(np.pi * k / 3)) / 2 for k in range(3)],
        rtol=1e-12)
    assert state.optimizer.param_groups[0]["lr"] == 0.0
    for got, want in zip(mets, jmets):
        assert abs(got["loss"] - float(want["loss"])) < LOSS_TOL
    want_proc = as_port(jstate.proc_params, jstate.proc_stats, "proc")
    want_clf = as_port(jstate.clf_params, jstate.clf_stats, "clf")
    check_stats(state.processor, want_proc)
    check_stats(state.classifier, want_clf, STEPS_CLF_STATS_TOL)
    slack = 2 * sum(lrs)
    check_params(state.processor, want_proc,
                 as_port(jgrads[0], {}, "proc"), slack)
    check_params(state.classifier, want_clf, as_port(jgrads[1], {}, "clf"),
                 slack, STEPS_CLF_PARAM_TOL)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["staged", "kernel"])
def test_eval_step_matches_jax(use_kernel, weights, batch):
    cfg = TrainConfig(lr=LR)
    proc, clf = jax_modules(use_kernel)
    jstate, _ = jcore.create_train_state(
        jax_config(cfg), proc, clf, jnp.asarray(batch[0]),
        jax.random.key(0), processor_variables=weights[0],
        classifier_variables=weights[1])
    jlogits, jmets = jcore.make_eval_step(jax_config(cfg), proc, clf)(
        jstate, jnp.asarray(batch[0]), jnp.asarray(batch[1], jnp.int32),
        jax.random.key(0))
    proc, clf = port_modules(weights, use_kernel)
    state = create_train_state(cfg, proc, clf)
    logits, mets = make_eval_step(cfg, proc, clf)(
        state, torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-4)
    assert abs(float(mets["loss"]) - float(jmets["loss"])) < LOSS_TOL
    assert float(mets["accuracy"]) == float(jmets["accuracy"])
    assert not proc.training and not clf.training


def test_checkpoint_round_trip(weights, batch, tmp_path):
    """Save after a step, restore into a state with other weights: the
    modules, optimizer, scheduler and step come back, and the next step
    is the same as the uninterrupted run's."""
    cfg = TrainConfig(lr=LR, lr_schedule="cosine", total_steps=4)
    raw, y = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    proc, clf = port_modules(weights, False)
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    step(state, raw, y)
    path = save_state(state, str(tmp_path / "ck" / "state.pt"))
    want = step(state, raw, y)

    proc2 = port_modules(weights, False)[0]
    clf2 = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                         num_classes=2, device="cpu",
                         generator=torch.Generator().manual_seed(5))
    state2 = create_train_state(cfg, proc2, clf2)
    restore_state(path, state2)
    assert state2.step == 1
    assert state2.scheduler.last_epoch == 1
    got = make_train_step(cfg, proc2, clf2)(state2, raw, y)
    assert float(got["loss"]) == float(want["loss"])
    for (name, a), b in zip(state.classifier.state_dict().items(),
                            state2.classifier.state_dict().values()):
        assert torch.equal(a, b), name
    for (name, a), b in zip(state.processor.state_dict().items(),
                            state2.processor.state_dict().values()):
        assert torch.equal(a, b), name


# --- ResNet batch norm in train mode --------------------------------------

@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_resnet_train_bn_stats_match_flax(block, rng):
    """One train-mode forward: every running mean and variance as flax's
    (momentum 0.9, BIASED batch variance), and the same logits."""
    fcls, pcls = {"basic": (jresnet.BasicBlock, resnet.BasicBlock),
                  "bottleneck": (jresnet.Bottleneck,
                                 resnet.Bottleneck)}[block]
    fmodel = jresnet.ResNet(block_cls=fcls, stage_sizes=(1, 1, 1, 1),
                            num_filters=8, num_classes=3)
    variables = randomize(fmodel.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False), rng)
    x = rng.normal(0.0, 1.0, (4, 32, 32, 3)).astype(np.float32)
    want_logits, mut = fmodel.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
    pmodel = resnet.ResNet(block_cls=pcls, stage_sizes=(1, 1, 1, 1),
                           num_filters=8, num_classes=3, device="cpu")
    pmodel.load_state_dict(convert.resnet_state_dict(variables))
    with torch.no_grad():
        logits = pmodel.train()(torch.from_numpy(
            np.transpose(x, (0, 3, 1, 2))))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=0, atol=1e-4)
    want = convert.resnet_state_dict({"params": variables["params"],
                                      "batch_stats": jax.device_get(
                                          mut["batch_stats"])})
    for name, b in pmodel.named_buffers():
        if "running" in name:
            assert rel_err(b, want[name]) < BN_TOL[block], (
                name, rel_err(b, want[name]))


def test_resnet_bn_eval_unchanged_and_loads():
    """FlaxBatchNorm2d is an nn.BatchNorm2d: eval mode and state dicts are
    torch's."""
    bn = resnet.FlaxBatchNorm2d(4, eps=1e-5, momentum=0.1)
    ref = torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1)
    ref.load_state_dict(bn.state_dict())
    x = torch.randn(3, 4, 5, 5, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for m in (bn, ref):
            m.running_mean.fill_(0.3)
            m.running_var.fill_(2.0)
        assert torch.equal(bn.eval()(x), ref.eval()(x))
        bn.train()(x)
        ref.train()(x)
    n = 3 * 5 * 5
    assert torch.allclose(bn.running_mean, ref.running_mean)
    # torch: 0.9 * 2 + 0.1 * var * n / (n - 1); flax: 0.9 * 2 + 0.1 * var
    var = x.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(bn.running_var, 1.8 + 0.1 * var, rtol=0, atol=1e-6)
    assert torch.allclose(ref.running_var, 1.8 + 0.1 * var * n / (n - 1),
                          rtol=0, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


# --- losses and metrics ---------------------------------------------------

def _loss_cases(rng):
    logits = rng.normal(0, 2, (6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6)
    seg = rng.normal(0, 2, (2, 1, 8, 8)).astype(np.float32)
    mask = (rng.uniform(0, 1, (2, 8, 8)) > 0.6).astype(np.float32)
    x, y = (rng.normal(0, 1, (2, 3, 4, 4)).astype(np.float32)
            for _ in range(2))
    t = torch.from_numpy
    nhwc = lambda a: np.transpose(a, (0, 2, 3, 1))  # noqa: E731
    return {
        "cross_entropy": (losses.cross_entropy_loss(t(logits), t(labels)),
                          jlosses.cross_entropy_loss(logits, labels)),
        "dice": (losses.dice_loss(t(seg), t(mask)),
                 jlosses.dice_loss(nhwc(seg), mask)),
        "dice_empty_target": (losses.dice_loss(t(seg), t(mask * 0)),
                              jlosses.dice_loss(nhwc(seg), mask * 0)),
        "l2": (losses.l2_regularization(t(x), t(y)),
               jlosses.l2_regularization(x, y)),
        "weighted": (losses.weighted_loss(losses.cross_entropy_loss, -1.0)(
            t(logits), t(labels)), jlosses.weighted_loss(
                jlosses.cross_entropy_loss, -1.0)(logits, labels)),
        "aux_l2": (losses.aux_loss("l2", 0.3)(t(x), t(y)),
                   jlosses.aux_loss("l2", 0.3)(x, y)),
        "accuracy_logits": (losses.accuracy(t(logits), t(labels)),
                            jlosses.accuracy(logits, labels)),
        "accuracy_preds": (losses.accuracy(t(labels[::-1].copy()), t(labels)),
                           jlosses.accuracy(labels[::-1], labels)),
        "iou_probs": (losses.iou_score(torch.sigmoid(t(seg)), t(mask)),
                      jlosses.iou_score(jax.nn.sigmoid(nhwc(seg)), mask)),
        "iou_logits": (losses.iou_score(t(seg), t(mask), from_logits=True),
                       jlosses.iou_score(nhwc(seg), mask, from_logits=True)),
    }


@pytest.mark.parametrize("case", sorted(_loss_cases(
    np.random.default_rng(0))))
def test_losses_match_jax(case, rng):
    got, want = _loss_cases(rng)[case]
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                               atol=1e-6)


def test_unported_options_raise():
    """What the port still refuses: an unknown aux loss or augmentation,
    adversarial training without a processor, and a state with nothing to
    train."""
    with pytest.raises(NotImplementedError):
        losses.aux_loss("ms_ssim")
    proc = port_processing(jax_variables(MILD_CAM, np.random.default_rng(0),
                                         perturb=False))
    clf = resnet.ResNet(stage_sizes=(1,), num_filters=8, device="cpu")
    with pytest.raises(ValueError, match="augmentation"):
        create_train_state(TrainConfig(augmentation="medium"), proc, clf)
    with pytest.raises(ValueError, match="needs a processor"):
        create_train_state(TrainConfig(adv_training=True), None, clf)
    with pytest.raises(ValueError, match="no parameters"):
        create_train_state(TrainConfig(freeze_processor=True,
                                       freeze_classifier=True), proc, clf)


def test_step_refuses_a_state_of_other_modules(weights, batch):
    """A step runs the modules of the state it is given; a state built for
    other modules raises instead of being silently ignored."""
    cfg = TrainConfig(lr=LR)
    raw, y = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    proc, clf = port_modules(weights, False)
    other = create_train_state(cfg, *port_modules(weights, False))
    for step in (make_train_step(cfg, proc, clf),
                 make_eval_step(cfg, proc, clf)):
        with pytest.raises(ValueError, match="other modules"):
            step(other, raw, y)
