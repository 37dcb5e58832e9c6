"""PyTorch port vs the JAX package: the fused ResNet stem.

Each plain kernel function of ``raw2logit_tpu_torch/kernels/stem.py``
against its Pallas kernel in interpret mode (``raw2logit_tpu/pallas/
stem.py``), ``StemTrain`` and ``stem_eval`` against ``stem_train`` (with
its VJP) and ``stem_eval``, the port's ResNet-18 with ``stem_kernel`` against
the flax ResNet with ``stem_pallas``, one train step with the flag against
the JAX step, and what the flag refuses. Also which stem the default
routes an input to, the eval-mode stem's backward (JAX's has none)
against float64 autograd through the plain eval stem, and that weights
and checkpoints load with the flag on or off.

All on the CPU, where the wrappers run their plain versions. Inputs come
from numpy seeds (as ``tests/test_stem_pallas.py``) at (2, 32, 32) and
(2, 32, 48): the JAX kernels need H a multiple of 32. The JAX results are
computed once per module (interpret mode is slow).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from raw2logit_tpu.models import resnet as jresnet
from raw2logit_tpu.pallas import stem as jstem
from raw2logit_tpu.training import core as jcore

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.kernels import stem
from raw2logit_tpu_torch.models import resnet
from raw2logit_tpu_torch.serving import Predictor
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from test_torch_isp import MILD_CAM, jax_variables, port_processing, rel_err
from test_torch_resnet import randomize
from test_torch_train import GRAD_TOL, LOSS_TOL, STATS_TOL

SHAPES = {"square": (2, 32, 32), "wide": (2, 32, 48)}
# tests/test_stem_pallas.py:34-45, 76-81: forward and statistics 2e-5
# (abs and rel), gradients 2e-4 of their scale
FWD_TOL, GRAD_SCALE_TOL = 2e-5, 2e-4
# ResNet with the fused stem vs flax with stem_pallas
# (tests/test_stem_pallas.py:103-154): logits 5e-4, running statistics
# 1e-5 abs / 1e-4 rel
LOGIT_TOL, RUN_ATOL, RUN_RTOL = 5e-4, 1e-5, 1e-4
# bn1's running variance with the flag vs FlaxBatchNorm2d, relative: the
# kernel path takes E[act^2] - E[act]^2 from float64 sums, torch's batch
# norm a float32 variance, unbiased and back; they differ by float32
# rounding of the variance (~1e-7 of it), which the 0.1 momentum scales
# down further
RUN_VAR_REL = 1e-6


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def stem_inputs(shape, seed=0):
    """x NHWC, w HWIO, gamma, beta, running mean and variance (numpy), as
    tests/test_stem_pallas.py:17-25."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, 3)).astype(np.float32),
            rng.normal(scale=0.1, size=(7, 7, 3, 64)).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32),
            (0.1 * rng.normal(size=64)).astype(np.float32),
            (0.05 * rng.normal(size=64)).astype(np.float32),
            (1.0 + 0.2 * rng.uniform(size=64)).astype(np.float32))


def port_inputs(inputs):
    x, w, *rest = inputs
    return (t(nchw(x)), t(np.transpose(w, (3, 2, 0, 1))),
            *(t(v) for v in rest))


def kernel_inputs(shape):
    """Inputs of the five kernels, shared by both frameworks: the conv's
    own input, act quantised to multiples of 1/8 (planted ties in every
    pooling window that has one, positive ones included), a pooled
    cotangent and BN coefficients."""
    x, w, gamma, beta, mean, var = stem_inputs(shape, seed=1)
    rng = np.random.default_rng(2)
    b, h, wd = shape
    act = np.round(rng.normal(size=(b, 64, h // 2, wd // 2)) * 8) / 8
    inv = (1.0 / np.sqrt(var + 1e-5)).astype(np.float32)
    return {"x": x, "w": w, "act": act.astype(np.float32),
            "d_pooled": rng.normal(size=(b, 64, h // 4, wd // 4)).astype(
                np.float32),
            "alpha": (gamma * inv).astype(np.float32),
            "shift": (beta - mean * gamma * inv).astype(np.float32),
            "mean": mean, "inv": inv,
            "c1": (0.01 * rng.normal(size=64)).astype(np.float32),
            "c2": (0.01 * rng.normal(size=64)).astype(np.float32)}


@functools.cache
def jax_kernel_results(name):
    """The five Pallas kernels (interpret mode) on ``kernel_inputs``, in
    the port's layouts: act, its sums; pooled; d_n and its sums; dW OIHW;
    d_x NCHW."""
    shape = SHAPES[name]
    k = kernel_inputs(shape)
    b, h, wd = shape
    f32 = jnp.float32
    xp = jstem.pad_phase_planes(jstem.space_to_depth(jnp.asarray(k["x"]), f32))
    w4, w4t = jstem.pack_weights(jnp.asarray(k["w"]), f32)
    sel_r, sel_c = jstem.selectors(h // 2, wd // 2, f32)
    act, s1, s2 = jstem._conv_fwd(xp, w4, f32, True)
    pooled = jstem._bnpool_fwd(jnp.asarray(k["act"]), k["alpha"], k["shift"],
                               sel_r, sel_c, f32, True)
    d_n, sd, sdx = jstem._pool_bn_bwd(
        jnp.asarray(k["act"]), jnp.asarray(k["d_pooled"]), k["alpha"],
        k["shift"], k["mean"], k["inv"], sel_r, sel_c, f32, True)
    g1 = k["alpha"]
    d_xs, dw = jstem._conv_bwd(xp, jnp.asarray(k["act"]), d_n, g1, k["c1"],
                               k["c2"], k["mean"], k["inv"], w4t, True)
    out = {"act": act, "s1": s1, "s2": s2, "pooled": pooled, "d_n": d_n,
           "sd": sd, "sdx": sdx,
           "dw": np.transpose(np.asarray(jstem._unpack_dw(dw)), (3, 2, 0, 1)),
           "d_x": nchw(jstem.depth_to_space_grad(d_xs, h, wd))}
    return {key: np.asarray(v) for key, v in out.items()}


def port_kernel_results(name):
    k = {key: t(v) for key, v in kernel_inputs(SHAPES[name]).items()}
    x, w = t(nchw(k["x"].numpy())), t(np.transpose(k["w"].numpy(),
                                                   (3, 2, 0, 1)))
    act, s1, s2 = stem.stem_conv(x, w)
    d_n, sd, sdx = stem.stem_pool_bwd(k["act"], k["d_pooled"], k["alpha"],
                                      k["shift"], k["mean"], k["inv"])
    # d_n from the JAX kernel, so that dW and d_x see the same cotangent
    d_n_j = t(jax_kernel_results(name)["d_n"])
    coef = (k["alpha"], k["c1"], k["c2"], k["mean"], k["inv"])
    return {"act": act, "s1": s1, "s2": s2,
            "pooled": stem.stem_bnpool(k["act"], k["alpha"], k["shift"]),
            "d_n": d_n, "sd": sd, "sdx": sdx,
            "dw": stem.stem_conv_dw(x, k["act"], d_n_j, coef),
            "d_x": stem.stem_conv_dx(k["act"], d_n_j, coef, w)}


KERNEL_OUTPUTS = {"conv": ("act", "s1", "s2"), "bnpool": ("pooled",),
                  "pool_bwd": ("d_n", "sd", "sdx"), "conv_dw": ("dw",),
                  "conv_dx": ("d_x",)}


@pytest.mark.parametrize("kernel", sorted(KERNEL_OUTPUTS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_kernel_functions_match_pallas(shape, kernel):
    """act, the statistics, pooled and d_n (with planted ties) within 2e-5
    abs and rel; dW and d_x within 2e-4 of their scale."""
    want = jax_kernel_results(shape)
    got = port_kernel_results(shape)
    for key in KERNEL_OUTPUTS[kernel]:
        g = got[key].double().numpy()
        if key in ("dw", "d_x"):
            assert rel_err(g, want[key]) < GRAD_SCALE_TOL, key
        else:
            np.testing.assert_allclose(g, want[key], rtol=FWD_TOL,
                                       atol=FWD_TOL, err_msg=key)
    if kernel == "pool_bwd":
        act = kernel_inputs(SHAPES[shape])["act"]
        assert (act[..., 1:] == act[..., :-1]).mean() > 0.02  # ties planted


@functools.cache
def jax_stem_results(name):
    """stem_train's outputs and VJP for a seeded cotangent, and
    stem_eval's output, interpret mode, NCHW."""
    x, w, gamma, beta, mean, var = (jnp.asarray(a) for a in
                                    stem_inputs(SHAPES[name], seed=2))
    (pooled, bm, bv), vjp = jax.vjp(
        lambda *a: jstem.stem_train(*a, 1e-5, jnp.float32, True),
        x, w, gamma, beta)
    ct = np.random.default_rng(7).normal(size=pooled.shape).astype(
        np.float32)
    d_x, d_w, d_g, d_b = vjp((jnp.asarray(ct), jnp.zeros_like(bm),
                              jnp.zeros_like(bv)))
    ev = jstem.stem_eval(x, w, gamma, beta, mean, var, 1e-5, jnp.float32,
                         True)
    return {"pooled": nchw(pooled), "mean": bm, "var": bv, "ct": nchw(ct),
            "d_x": nchw(d_x), "d_w": np.transpose(np.asarray(d_w),
                                                  (3, 2, 0, 1)),
            "d_gamma": d_g, "d_beta": d_b, "eval": nchw(ev)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stem_train_matches_jax(shape):
    want = {k: np.asarray(v) for k, v in jax_stem_results(shape).items()}
    x, w, gamma, beta, _, _ = (v.requires_grad_(True) for v in port_inputs(
        stem_inputs(SHAPES[shape], seed=2)))
    pooled, mean, var = stem.StemTrain.apply(x, w, gamma, beta, 1e-5)
    assert not mean.requires_grad and not var.requires_grad
    for key, got in (("pooled", pooled), ("mean", mean), ("var", var)):
        np.testing.assert_allclose(got.detach().numpy(), want[key],
                                   rtol=FWD_TOL, atol=FWD_TOL, err_msg=key)
    grads = torch.autograd.grad(pooled, (x, w, gamma, beta), t(want["ct"]))
    for key, got in zip(("d_x", "d_w", "d_gamma", "d_beta"), grads):
        assert rel_err(got.numpy(), want[key]) < GRAD_SCALE_TOL, key


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stem_eval_matches_jax(shape):
    x, w, gamma, beta, mean, var = port_inputs(stem_inputs(SHAPES[shape],
                                                           seed=2))
    got = stem.stem_eval(x, w, gamma, beta, mean, var)
    np.testing.assert_allclose(got.numpy(), jax_stem_results(shape)["eval"],
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_stem_reference_matches_jax():
    """The plain stem (train and eval mode, with the running-statistics
    update) against the JAX package's stem_reference."""
    inputs = stem_inputs(SHAPES["wide"], seed=3)
    for train in (True, False):
        want = jstem.stem_reference(*(jnp.asarray(a) for a in inputs),
                                    train=train)
        got = stem.stem_reference(*port_inputs(inputs), train=train)
        np.testing.assert_allclose(got[0].numpy(), nchw(want[0]),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=FWD_TOL, atol=FWD_TOL)


# --- ResNet-18 with the fused stem -----------------------------------------

def random_variables(fmodel, rng, size=32):
    """Variables of the flax ``fmodel`` drawn from ``rng`` without running
    its init: kernels normal with variance 1 / fan-in, then ``randomize``
    (BN scales, biases and statistics, the fc bias)."""
    shapes = jax.eval_shape(functools.partial(fmodel.init, train=False),
                            jax.random.key(0), jnp.zeros((1, size, size, 3)))
    draw = lambda s: (rng.normal(size=s.shape) / np.sqrt(  # noqa: E731
        np.prod(s.shape[:-1]) if len(s.shape) > 1 else 1.0)).astype(
            np.float32)
    return randomize(jax.tree.map(draw, shapes), rng)


@functools.cache
def resnet_pair():
    """(randomized variables of a flax ResNet-18, input x NHWC, and the
    logits of the flax ResNet-18 with stem_pallas: eval, train, and its
    batch stats after the train-mode call). B = 8 at 32x32: at B = 2 the
    last stage's batch norms see two values per channel, and even the
    plain stems of the two frameworks then differ by 1e-3 in train-mode
    logits."""
    fmodel = jresnet.ResNet(num_classes=5, stem_pallas=True)
    rng = np.random.default_rng(4)
    variables = random_variables(fmodel, rng)
    x = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    ev = fmodel.apply(variables, x, train=False)
    tr, mut = fmodel.apply(variables, x, train=True, mutable=["batch_stats"])
    return variables, x, np.asarray(ev), np.asarray(tr), jax.device_get(mut)


def port_resnet(variables, **kwargs):
    model = resnet.ResNet(num_classes=5, device="cpu", **kwargs)
    model.load_state_dict(convert.resnet_state_dict(variables))
    return model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_stem_kernel_matches_jax_stem_pallas(train):
    variables, x, ev, tr, mut = resnet_pair()
    model = port_resnet(variables, stem_kernel=True).train(train)
    with torch.no_grad():
        logits = model(t(nchw(x)))
    np.testing.assert_allclose(logits.numpy(), tr if train else ev,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    want = convert.resnet_state_dict(
        {"params": variables["params"],
         "batch_stats": mut["batch_stats"] if train
         else variables["batch_stats"]})
    for name, b in model.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(b.numpy(), want[name].numpy(),
                                       rtol=RUN_RTOL, atol=RUN_ATOL,
                                       err_msg=name)


def test_running_statistics_update_as_flax_batch_norm():
    """Train mode with the flag updates bn1 as FlaxBatchNorm2d does on the
    plain stem: r <- 0.9 r + 0.1 batch, the variance biased; the number of
    batches counts; logits agree within LOGIT_TOL, the JAX package's own
    limit for its two stems (tests/test_stem_pallas.py:126-133): the
    train-mode batch norms of the last stages see 8 values per channel
    and amplify float32 rounding, by 2e-5 with one thread."""
    variables, x, _, _, _ = resnet_pair()
    on, off = (port_resnet(variables, stem_kernel=k).train()
               for k in (True, False))
    with torch.no_grad():
        for _ in range(2):
            la, lb = on(t(nchw(x))), off(t(nchw(x)))
    np.testing.assert_allclose(la.numpy(), lb.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    np.testing.assert_allclose(on.bn1.running_mean.numpy(),
                               off.bn1.running_mean.numpy(), rtol=1e-6,
                               atol=1e-7)
    assert rel_err(on.bn1.running_var, off.bn1.running_var) < RUN_VAR_REL
    assert int(on.bn1.num_batches_tracked) == 2


# --- one train step with the flag ------------------------------------------

@functools.cache
def step_setup():
    """JAX variables of the ISP and of a width-64 ResNet with one block
    per stage (random BN statistics), and a batch (B = 8, 32x32 smoothed
    mosaics) with labels."""
    rng = np.random.default_rng(5)
    pv = jax_variables(MILD_CAM, rng, perturb=True, size=32)
    cv = random_variables(jresnet.ResNet(stage_sizes=(1, 1, 1, 1),
                                         num_classes=2), rng)
    x = rng.uniform(0.0, 1.0, (8, 36, 36))
    x = sum(x[:, i:i + 32, j:j + 32] for i in range(5) for j in range(5))
    x = (0.25 + 0.5 * (x - x.min()) / (x.max() - x.min())).astype(np.float32)
    return pv, cv, x, np.array([0, 1, 1, 0, 1, 0, 0, 1])


@functools.cache
def jax_step():
    """The JAX train step's loss and gradients with stem_pallas
    (interpret mode): ``jcore._forward`` and ``task_loss_fn`` under
    ``jax.value_and_grad``, as ``jcore.make_train_step`` computes them,
    with the batch statistics the step keeps. The optimizer's update is
    the port's Adam, held to optax's by tests/test_torch_train.py."""
    from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
    pv, cv, raw, y = step_setup()
    cfg = jcore.TrainConfig(**dataclasses.asdict(TrainConfig(lr=1e-3)))
    proc = JaxProcessing(camera_parameters=MILD_CAM)
    clf = jresnet.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=2,
                         stem_pallas=True)
    raw, y = jnp.asarray(raw), jnp.asarray(y, jnp.int32)
    key = jax.random.key(2)

    @jax.jit
    def loss_and_grads(trainable):
        def loss_fn(trainable):
            logits, _, _, _, new_cs = jcore._forward(
                cfg, proc, clf, trainable[0], pv["batch_stats"],
                trainable[1], cv["batch_stats"], raw, key, True)
            return jcore.task_loss_fn(cfg)(logits, y), new_cs
        return jax.value_and_grad(loss_fn, has_aux=True)(trainable)

    return jax.device_get(loss_and_grads((pv["params"], cv["params"])))


def test_train_step_with_stem_kernel_matches_jax():
    """make_train_step takes a classifier built with the flag: the loss,
    the gradients of both modules (the stem's through StemTrain) and the
    classifier's BN statistics after one step, against the JAX step with
    stem_pallas."""
    pv, cv, raw, y = step_setup()
    (loss, clf_stats), (g_proc, g_clf) = jax_step()
    proc = port_processing(pv)
    clf = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_classes=2,
                        device="cpu", stem_kernel=True)
    clf.load_state_dict(convert.resnet_state_dict(cv))
    cfg = TrainConfig(lr=1e-3)
    state = create_train_state(cfg, proc, clf)
    mets = make_train_step(cfg, proc, clf)(state, torch.from_numpy(raw),
                                           torch.from_numpy(y))
    assert abs(float(mets["loss"]) - float(loss)) < LOSS_TOL
    want = {**convert.isp_state_dict({"params": g_proc}),
            **convert.resnet_state_dict({"params": g_clf})}
    for name, p in [*proc.named_parameters(), *clf.named_parameters()]:
        assert rel_err(p.grad, want[name]) < GRAD_TOL, (
            name, rel_err(p.grad, want[name]))
    stats = convert.resnet_state_dict({"params": cv["params"],
                                       "batch_stats": clf_stats})
    for name, b in clf.named_buffers():
        if "running" in name:
            assert rel_err(b, stats[name]) < STATS_TOL, name


# --- what the flag refuses ---------------------------------------------------

RAISES = {
    "num_filters": (NotImplementedError, lambda: resnet.ResNet(
        num_filters=32, device="cpu", stem_kernel=True)),
    "in_channels": (NotImplementedError, lambda: resnet.resnet_model(
        in_channels=4, device="cpu", stem_kernel=True)),
    "float64": (NotImplementedError, lambda: resnet.ResNet(
        stage_sizes=(1,), device="cpu", stem_kernel=True).double()(
            torch.zeros(1, 3, 32, 32, dtype=torch.float64))),
    "height": (ValueError, lambda: resnet.ResNet(
        stage_sizes=(1,), device="cpu", stem_kernel=True)(
            torch.zeros(1, 3, 30, 32))),
    "width": (ValueError, lambda: stem.stem_eval(
        torch.zeros(1, 3, 32, 34), torch.zeros(64, 3, 7, 7),
        *torch.ones(4, 64))),
}


@pytest.mark.parametrize("case", sorted(RAISES))
def test_stem_kernel_raises_instead_of_falling_back(case):
    err, fn = RAISES[case]
    with pytest.raises(err):
        fn()


def test_eval_mode_without_gradient_runs():
    """Eval mode under no_grad, or with nothing that needs a gradient,
    runs the forward kernels only and raises nothing."""
    model = resnet.ResNet(stage_sizes=(1,), device="cpu",
                          stem_kernel=True).eval().requires_grad_(False)
    x = torch.zeros(1, 3, 32, 32)
    assert model(x).shape == (1, 2)
    with torch.no_grad():
        assert model.requires_grad_(True)(x).shape == (1, 2)


# --- which stem runs ---------------------------------------------------------

# case: (ResNet keyword arguments, input shape, input dtype, on the card,
# return_features, train mode, runs the fused stem). "card" cases patch
# resnet.on_card, so that the CPU stands for the card: the fused stem
# then runs the kernels' plain versions.
ROUTES = {
    "card_256_train": ({}, (1, 3, 256, 256), torch.float32, True, False,
                       True, True),
    "card_eval": ({}, (2, 3, 32, 48), torch.float32, True, False, False,
                  True),
    "card_bfloat16": ({"dtype": torch.bfloat16}, (2, 3, 32, 32),
                      torch.float32, True, False, True, True),
    "cpu": ({}, (2, 3, 32, 32), torch.float32, False, False, True, False),
    "height_30": ({}, (1, 3, 30, 32), torch.float32, True, False, True,
                  False),
    "width_34": ({}, (1, 3, 32, 34), torch.float32, True, False, False,
                 False),
    "float64": ({}, (1, 3, 32, 32), torch.float64, True, False, True, False),
    "return_features": ({}, (1, 3, 32, 32), torch.float32, True, True, True,
                        False),
    "filters_32": ({"num_filters": 32}, (1, 3, 32, 32), torch.float32, True,
                   False, True, False),
    "in_channels_4": ({"in_channels": 4}, (1, 4, 32, 32), torch.float32,
                      True, False, True, False),
    "forced_on_cpu": ({"stem_kernel": True}, (1, 3, 32, 32), torch.float32,
                      False, False, False, True),
    "forced_off_card": ({"stem_kernel": False}, (1, 3, 32, 32),
                        torch.float32, True, False, True, False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_stem_routes_by_its_input(case, monkeypatch):
    """The default ``stem_kernel=None`` runs the fused stem on the card
    for a float32 (B, 3, H, W) with H, W multiples of 4 on a 64-filter,
    3-channel model, in train and eval mode and in bfloat16; the plain
    stem on the CPU, on other shapes, dtypes and widths, and on the
    features path, without an error. ``True`` and ``False`` force their
    stems."""
    kwargs, shape, dtype, card, features, train, fused = ROUTES[case]
    monkeypatch.setattr(resnet, "on_card", lambda x: card)
    calls = []
    for name in ("stem_train", "stem_eval"):
        fn = getattr(resnet, name)
        monkeypatch.setattr(resnet, name, lambda *a, _fn=fn, **k: (
            calls.append(_fn), _fn(*a, **k))[1])
    model = resnet.ResNet(stage_sizes=(1,), device="cpu", **kwargs)
    model = model.to(dtype).train(train)
    x = torch.randn(shape, dtype=dtype, generator=torch.Generator()
                    .manual_seed(0))
    assert model.runs_fused_stem(x, features) == fused
    with torch.no_grad():
        out = model(x, return_features=True, depth=2) if features \
            else model(x)
    assert calls == ([stem.stem_train if train else stem.stem_eval]
                     if fused else [])
    if features:
        assert out[1].shape[2:] == (shape[2] // 2, shape[3] // 2)
    else:
        assert out.shape == (shape[0], 2) and bool(torch.isfinite(out).all())


# --- the eval-mode stem's backward -----------------------------------------

def exact_stem_inputs(shape, seed):
    """x of small integers, constant over 16x16 blocks, and w of
    multiples of 1/64: every product and sum of the conv is exact in
    float32, in bfloat16's products and in float64, so each precision
    computes the same act, and the positions inside a block tie in the
    pooling windows (three quarters of the windows with a positive
    maximum at 32x32 and 32x48)."""
    b, h, wd = shape
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (b, 3, h // 16, wd // 16)).repeat(16, 2).repeat(
        16, 3)
    w = rng.integers(-8, 9, (64, 3, 7, 7)) / 64
    return t(x), t(w)


# case: (input, shape, compute dtype, frozen model): "random" is
# stem_inputs' normal draws, "exact" is exact_stem_inputs'. The frozen
# model is forensics': no parameter needs a gradient, only x does.
EVAL_BWD = {
    "square": ("random", (2, 32, 32), torch.float32, False),
    "wide": ("random", (2, 32, 48), torch.float32, False),
    "ties": ("exact", (2, 32, 32), torch.float32, False),
    "frozen": ("random", (2, 32, 48), torch.float32, True),
    "bfloat16_ties": ("exact", (2, 32, 48), torch.bfloat16, False),
}
# measured on the CPU, over each gradient's largest magnitude: float32
# within 3.1e-7 (d_x 2.5e-7, dW 3.1e-7, dgamma 9.7e-8, dbeta 3.5e-8);
# bfloat16 d_x, dW and dbeta equal, dgamma 9e-8 (on exact inputs the
# roundings land alike; what is left is float32 against float64 sums)
EVAL_GRAD_TOL = 1e-5


def plain_eval_stem(x, w, gamma, beta, mean, var, eps=1e-5):
    """The plain eval-mode stem: conv, batch norm with the running
    statistics, ReLU, the 3x3/2 max pool."""
    n = F.batch_norm(F.conv2d(x, w, stride=2, padding=3), mean, var, gamma,
                     beta, False, 0.0, eps)
    return resnet.stem_max_pool(F.relu(n))


def rounded_eval_stem_grads(x, w, gamma, beta, mean, var, d_pooled, dtype):
    """(d_x, dW, dgamma, dbeta) of ``plain_eval_stem`` for ``d_pooled``, by
    autograd in float64. In bfloat16 autograd runs piece by piece with the
    rounded plain forms between the pieces, where the kernels' bfloat16
    forms round: x and w before the conv, act as stored, d_n as stored
    (dgamma and dbeta from the unrounded d_n), and d_a."""
    r = functools.partial(stem.rounded, dtype=dtype)
    x, w, gamma, beta, mean, var, d_pooled = (
        v.double() for v in (r(x), r(w), gamma, beta, mean, var, d_pooled))
    leaves = [v.requires_grad_(True) for v in (x, w, gamma, beta)]
    if dtype == torch.float32:
        return torch.autograd.grad(plain_eval_stem(*leaves, mean, var),
                                   leaves, d_pooled)
    act = F.conv2d(x, w, stride=2, padding=3)
    act_s = r(act.detach()).requires_grad_(True)
    n = F.batch_norm(act_s, mean, var, gamma, beta, False, 0.0, 1e-5)
    n_leaf = n.detach().requires_grad_(True)
    d_n, = torch.autograd.grad(resnet.stem_max_pool(F.relu(n_leaf)), n_leaf,
                               d_pooled)
    d_gamma, d_beta = torch.autograd.grad(n, (gamma, beta), d_n,
                                          retain_graph=True)
    d_a, = torch.autograd.grad(n, act_s, r(d_n))
    d_x, d_w = torch.autograd.grad(act, (x, w), r(d_a))
    return d_x, d_w, d_gamma, d_beta


@pytest.mark.parametrize("case", sorted(EVAL_BWD))
def test_eval_stem_backward_matches_plain_autograd(case):
    """An eval-mode ResNet with ``stem_kernel=True`` (the kernels' plain
    versions on the CPU): the gradients of x, conv1 and bn1 (``_StemEval``
    's backward) against autograd through the plain eval stem on the same
    pooled cotangent, in float64 (bfloat16: the rounded plain forms); the
    running statistics do not move; a frozen model gives x alone a
    gradient."""
    kind, shape, dtype, frozen = EVAL_BWD[case]
    b, h, wd = shape
    x, w, gamma, beta, mean, var = port_inputs(stem_inputs(shape, seed=8))
    if kind == "exact":
        x, w = exact_stem_inputs(shape, seed=9)
    model = resnet.ResNet(stage_sizes=(1,), device="cpu", stem_kernel=True,
                          dtype=dtype)
    with torch.no_grad():
        for p, v in ((model.conv1.weight, w), (model.bn1.weight, gamma),
                     (model.bn1.bias, beta), (model.bn1.running_mean, mean),
                     (model.bn1.running_var, var)):
            p.copy_(v)
    model.eval().requires_grad_(not frozen)
    seen = {}
    model.layer1.register_forward_pre_hook(
        lambda _, args: seen.update(pooled=args[0]))
    xg = x.clone().requires_grad_(True)
    logits = model(xg)
    seen["pooled"].register_hook(lambda g: seen.update(d_pooled=g))
    logits.square().sum().backward()
    want = rounded_eval_stem_grads(x, w, gamma, beta, mean, var,
                                   seen["d_pooled"], dtype)
    got = (xg.grad, model.conv1.weight.grad, model.bn1.weight.grad,
           model.bn1.bias.grad)
    for name, g, v in zip(("d_x", "d_w", "d_gamma", "d_beta"), got, want):
        if frozen and name != "d_x":
            assert g is None, name
        else:
            assert rel_err(g, v.numpy()) < EVAL_GRAD_TOL, (name,
                                                            rel_err(g, v))
    assert torch.equal(model.bn1.running_mean, mean)
    assert torch.equal(model.bn1.running_var, var)
    if kind == "exact":  # ties planted among positive window maxima
        taps = stem.window_taps(F.relu(F.batch_norm(
            F.conv2d(x.double(), w.double(), stride=2, padding=3),
            mean.double(), var.double(), gamma.double(), beta.double(),
            False, 0.0, 1e-5)))
        best = taps.max(0).values
        assert ((taps == best).sum(0)[best > 0] > 1).double().mean() > 0.5


# --- weights and checkpoints -------------------------------------------------

def test_checkpoints_load_with_the_flag_on_or_off(tmp_path, rng):
    """A state dict or torch.save checkpoint written with the flag on
    loads strictly with it off, and the reverse; eval logits agree."""
    x = torch.from_numpy(rng.normal(size=(2, 3, 32, 32)).astype(np.float32))
    for src, dst in ((True, False), (False, True)):
        a = resnet.ResNet(stage_sizes=(1, 1), device="cpu", stem_kernel=src,
                          generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            a.train()(x)  # moves bn1's running statistics
        path = tmp_path / f"clf_{src}.pt"
        torch.save(a.state_dict(), path)
        for sd in (a.state_dict(), torch.load(path)):
            b = resnet.ResNet(stage_sizes=(1, 1), device="cpu",
                              stem_kernel=dst)
            b.load_state_dict(sd, strict=True)
            for name, v in a.state_dict().items():
                assert torch.equal(v, b.state_dict()[name]), name
            with torch.no_grad():
                np.testing.assert_allclose(b.eval()(x).numpy(),
                                           a.eval()(x).numpy(), rtol=1e-5,
                                           atol=1e-6)


def test_convert_reads_a_stem_pallas_tree():
    """convert.resnet_state_dict of a JAX ``stem_pallas=True`` tree loads
    strictly into the port's ResNet-18 with the flag; the tree is the flax
    stem's."""
    shapes = {}
    for flag in (False, True):
        fmodel = jresnet.resnet_model("resnet18", fc_out_features=9,
                                      stem_pallas=flag)
        shapes[flag] = jax.eval_shape(
            functools.partial(fmodel.init, train=False), jax.random.key(0),
            jnp.zeros((1, 32, 32, 3)))
    assert (jax.tree.map(lambda s: s.shape, shapes[True])
            == jax.tree.map(lambda s: s.shape, shapes[False]))
    rng = np.random.default_rng(6)
    variables = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes[True])
    model = resnet.resnet_model("resnet18", fc_out_features=9, device="cpu",
                                stem_kernel=True)
    sd = convert.resnet_state_dict(variables)
    model.load_state_dict(sd, strict=True)
    assert torch.equal(model.conv1.weight, sd["conv1.weight"])
    assert torch.equal(model.bn1.running_var, sd["bn1.running_var"])


def test_predictor_serves_a_stem_kernel_classifier(raw_batch):
    """Predictor takes a classifier built with the flag (eval mode, under
    inference_mode): logits as the plain stem's."""
    variables, _, _, _, _ = resnet_pair()
    proc = port_processing(step_setup()[0])
    on, off = (Predictor(proc, port_resnet(variables, stem_kernel=k),
                         device="cpu")(raw_batch) for k in (True, False))
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=1e-5, atol=1e-5)

