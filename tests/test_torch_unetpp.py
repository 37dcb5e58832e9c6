"""PyTorch port vs the JAX package: U-Net++ (``models/unetpp.py``) and the
segmentation path built on it.

The same inputs and weights (carried across by
``raw2logit_tpu_torch.convert``) through flax and the port: the U-Net++
forward in train and eval mode with its running statistics, for BasicBlock
and Bottleneck encoders at depths 3 and 5 with narrow decoders and once at
the published widths; the parameter tree, one to one; ``remat``; a
segmentation train step against JAX's ``make_train_step``; the training
CLI's segmentation run and ``Predictor.from_run`` on a segmentation run;
and the combinations that the JAX package cannot run, which the port
refuses.

All on the CPU at 64x64. JAX's results are shared through module-scoped
fixtures.
"""

import copy
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.augment import get_augmentation as jax_augmentation
from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.models import unetpp as junetpp
from raw2logit_tpu.serving import Predictor as JaxPredictor
from raw2logit_tpu.training import core as jcore

from raw2logit_tpu_torch import augment, convert, serving
from raw2logit_tpu_torch.data import SyntheticRawSegmentation, dng
from raw2logit_tpu_torch.models import unetpp
from raw2logit_tpu_torch.serving import Predictor
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from raw2logit_tpu_torch.training import train as cli
from test_torch_cli import jax_draws
from test_torch_isp import DRONE_CAM, jax_variables, port_processing, rel_err
from test_torch_resnet import LOGIT_ATOL
from test_torch_serving import write_port_run
from test_torch_train import GRAD_TOL, LOSS_TOL, STATS_TOL, check_params

SIZE = 64
# (encoder, depth, decoder channels, batch): both block kinds at both
# depths with narrow decoders, and the published widths (the CLI's
# segmenter) at B = 1
CONFIGS = {"resnet18_d3": ("resnet18", 3, (16, 8, 4), 2),
           "resnet18_d5": ("resnet18", 5, (32, 16, 8, 8, 4), 2),
           "resnet50_d3": ("resnet50", 3, (16, 8, 4), 2),
           "resnet50_d5": ("resnet50", 5, (32, 16, 8, 8, 4), 2),
           "published": ("resnet34", 5, (256, 128, 64, 32, 16), 1)}
# running statistics after one train-mode forward, relative to each
# tensor's largest (as test_torch_train's BN_TOL): the deepest nodes sit
# behind about 40 float32 convolutions of two implementations
U_STATS_TOL = 1e-4
# In train mode the deepest batch norms normalise over few values (4 at
# the published widths, B = 1: 2x2 positions), which amplifies float32
# rounding: there flax's float32 logits read 1.09e-4 from the port's
# float64 forward and 1.13e-4 from the port's float32 ones, which read
# 6.7e-5 from float64. So train-mode logits are held to flax within
# LOGIT_ATOL or F64_FACTOR times flax's own distance from the float64
# forward, whichever is larger, and the port no further from float64
# than LOGIT_ATOL or flax's distance.
F64_FACTOR = 2.0
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs several test
    processes at once, and a thread pool per process the size of the
    machine oversubscribes its cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def random_variables(model, x_shape, rng):
    """flax variables of ``model`` for inputs of ``x_shape``, as numpy:
    kernels N(0, 1 / fan_in), BN scales U(0.5, 1.5), biases and running
    means N(0, 0.1), running variances U(0.5, 2). The tree comes from
    ``jax.eval_shape``, so that no flax init runs."""
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


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@functools.cache
def build_pair(name):
    """(flax U-Net++, its random variables, the port's with them, NHWC
    input), once per configuration."""
    encoder, depth, decoder, batch = CONFIGS[name]
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    kw = dict(encoder_name=encoder, encoder_depth=depth,
              decoder_channels=decoder, classes=2)
    fmodel = junetpp.UNetPlusPlus(**kw)
    variables = random_variables(fmodel, (1, SIZE, SIZE, 3), rng)
    pmodel = unetpp.UNetPlusPlus(**kw, device="cpu")
    pmodel.load_state_dict(convert.unetpp_state_dict(variables))
    x = rng.normal(0.0, 1.0, (batch, SIZE, SIZE, 3)).astype(np.float32)
    return fmodel, variables, pmodel, x


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_matches_flax(name, train):
    """Logits at LOGIT_ATOL (in train mode as F64_FACTOR says); in train
    mode also every running mean and variance after the forward (momentum
    0.9, biased variance)."""
    fmodel, variables, pmodel, x = build_pair(name)
    pmodel = pmodel.train(train)
    before = {k: v.clone() for k, v in pmodel.state_dict().items()}
    with torch.no_grad():
        got = pmodel(torch.from_numpy(nchw(x))).numpy()
    limit = LOGIT_ATOL
    if not train:
        want = fmodel.apply(variables, x, train=False)
    else:
        want, mut = fmodel.apply(variables, x, train=True,
                                 mutable=["batch_stats"])
        stats = convert.unetpp_state_dict(
            {"params": variables["params"],
             "batch_stats": jax.device_get(mut["batch_stats"])})
        for k, b in pmodel.named_buffers():
            if "running" in k:
                assert rel_err(b, stats[k]) < U_STATS_TOL, (
                    k, rel_err(b, stats[k]))
        pmodel.load_state_dict(before)
        with torch.no_grad():
            f64 = copy.deepcopy(pmodel).double()(
                torch.from_numpy(nchw(x)).double()).numpy()
        flax_f64 = float(np.abs(nchw(want) - f64).max())
        port_f64 = float(np.abs(got - f64).max())
        assert port_f64 <= max(LOGIT_ATOL, flax_f64), (port_f64, flax_f64)
        limit = max(LOGIT_ATOL, F64_FACTOR * flax_f64)
    assert got.shape == nchw(want).shape == (len(x), 2, SIZE, SIZE)
    np.testing.assert_allclose(got, nchw(want), rtol=0, atol=limit)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tree_matches_flax_one_to_one(name):
    """Every flax leaf lands on exactly one port parameter or buffer of
    its shape and the port has nothing else: the encoder holds only the
    stages its depth runs and no fc, as flax creates them lazily."""
    encoder, depth, decoder, _ = CONFIGS[name]
    fmodel, variables, pmodel, _ = build_pair(name)
    leaves = jax.tree_util.tree_leaves(variables)
    sd = convert.unetpp_state_dict(variables)
    mapped = {k: tuple(v.shape) for k, v in sd.items()
              if not k.endswith("num_batches_tracked")}
    assert len(mapped) == len(leaves)
    got = {k: tuple(v.shape) for k, v in pmodel.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    assert pmodel.encoder.fc is None
    stages = {k.split(".")[1] for k in got if k.startswith("encoder.layer")}
    assert stages == {f"layer{i + 1}" for i in range(depth - 1)}
    assert all(p.requires_grad for p in pmodel.parameters())


@pytest.mark.parametrize("name", ["resnet18_d3", "resnet50_d5"])
def test_remat_is_bitwise_the_same(name):
    """remat=True recomputes every decoder node in the backward (each
    node's forward runs twice) and changes nothing: output, gradients and
    running statistics bitwise equal to remat=False (JAX holds its remat
    the same way, tests/test_training.py:178)."""
    _, _, base, x = build_pair(name)
    x = torch.from_numpy(nchw(x))
    sd = base.state_dict()
    runs = []
    for remat in (False, True):
        encoder, depth, decoder, _ = CONFIGS[name]
        m = unetpp.UNetPlusPlus(encoder, depth, decoder, classes=2,
                                remat=remat, device="cpu")
        m.load_state_dict(sd)
        calls = []
        m.x_0_1.register_forward_pre_hook(lambda *a: calls.append(1))
        out = m.train()(x)
        (out ** 2).sum().backward()
        runs.append((out.detach(), {k: p.grad for k, p in
                                    m.named_parameters()},
                     {k: b for k, b in m.named_buffers()}, len(calls)))
    (out0, g0, b0, n0), (out1, g1, b1, n1) = runs
    assert (n0, n1) == (1, 2)
    assert torch.equal(out0, out1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


def saved_bytes(m, x):
    """Bytes of the distinct storages that a train-mode forward of ``m``
    keeps for the backward outside of any ``torch.utils.checkpoint``."""
    seen = {}

    def pack(t):
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        m.train()(x)
    return sum(seen.values())


@pytest.mark.parametrize("name", ["resnet18_d3", "resnet50_d5"])
def test_remat_keeps_no_node_internals(name):
    """What remat is for: the forward keeps fewer bytes for the backward,
    by at least each node's three internal planes (conv0's output, its
    ReLU's, conv1's output), which the backward recomputes."""
    _, _, base, x = build_pair(name)
    x = torch.from_numpy(nchw(x))
    encoder, depth, decoder, _ = CONFIGS[name]
    kept = {}
    for remat in (False, True):
        m = unetpp.UNetPlusPlus(encoder, depth, decoder, classes=2,
                                remat=remat, device="cpu")
        m.load_state_dict(base.state_dict())
        kept[remat] = saved_bytes(m, x)
    rows = list(decoder)[::-1]
    internals = sum(3 * rows[i] * x.shape[0] * (SIZE >> i) ** 2 * 4
                    for j in range(1, depth + 1) for i in range(depth + 1 - j))
    assert kept[True] + internals <= kept[False], (kept, internals)


# --- the segmentation train step -----------------------------------------

SEG_UNET = dict(encoder_name="resnet18", encoder_depth=3,
                decoder_channels=(16, 8, 4), classes=1)


@pytest.fixture(scope="module")
def seg_weights():
    """The drone ISP (perturbed, BN statistics) and the narrow
    one-class resnet18 depth-3 U-Net++, as numpy JAX variables."""
    rng = np.random.default_rng(11)
    pv = jax_variables(DRONE_CAM, rng, perturb=True)
    uv = random_variables(junetpp.UNetPlusPlus(**SEG_UNET),
                          (1, SIZE, SIZE, 3), rng)
    return pv, uv


@pytest.fixture(scope="module")
def seg_batch():
    """Drone mosaics (B = 2, 64x64) and their masks."""
    ds = SyntheticRawSegmentation(n=2, h=SIZE, w=SIZE, seed=4)
    return (np.stack([ds[i][0] for i in range(2)]),
            np.stack([ds[i][1] for i in range(2)]))


def weak_key():
    """A key whose weak draws flip and turn."""
    for i in range(64):
        key = jax.random.key(i)
        d = jax_draws("weak", key, None)
        if d["k"] and (d["hflip"] or d["vflip"]):
            return key, d
    raise AssertionError("no key flips and turns")


def jax_seg_step(cfg, weights, batch, key):
    """JAX's ``make_train_step`` once: (new state, metrics, gradients)."""
    cfg = jcore.TrainConfig(**{f: getattr(cfg, f) for f in
                               cfg.__dataclass_fields__})
    raw, y = jnp.asarray(batch[0]), jnp.asarray(batch[1])
    proc = JaxProcessing(camera_parameters=DRONE_CAM)
    clf = junetpp.UNetPlusPlus(**SEG_UNET)
    state, tx = jcore.create_train_state(
        cfg, proc, clf, raw, jax.random.key(0),
        processor_variables=weights[0], classifier_variables=weights[1])
    aug = jax_augmentation(cfg.augmentation)

    @jax.jit
    def grads(state):
        def loss_fn(trainable):
            logits = jcore._forward(cfg, proc, clf, trainable[0],
                                    state.proc_stats, trainable[1],
                                    state.clf_stats, raw, key, True)[0]
            y_t = y if aug is None else aug(key, y, is_mask=True)
            return jcore.task_loss_fn(cfg)(logits[..., 0], y_t)
        return jax.grad(loss_fn)((state.proc_params, state.clf_params))

    g = grads(state)
    step = jcore.make_train_step(cfg, proc, clf, tx, donate=False)
    state, mets = step(state, raw, y, key)
    return jax.device_get(state), jax.device_get(mets), jax.device_get(g)


def jax_isp_vjp(weights, raw, g):
    """JAX's ISP gradients (train mode, as the step runs it) for the
    cotangent ``g`` (NCHW) of its output."""
    proc = JaxProcessing(camera_parameters=DRONE_CAM)

    def out(params):
        return proc.apply({"params": params,
                           "batch_stats": weights[0]["batch_stats"]},
                          jnp.asarray(raw), train=True,
                          mutable=["batch_stats"])[0][0]
    _, vjp = jax.vjp(out, weights[0]["params"])
    return jax.device_get(vjp(jnp.asarray(np.transpose(g, (0, 2, 3, 1))))[0])


@pytest.mark.parametrize("aug", ["none", "weak"])
def test_segmentation_train_step_matches_jax(aug, seg_weights, seg_batch,
                                             monkeypatch):
    """Parametrized ISP (the port on its plain path) -> U-Net++ -> Dice,
    one Adam step: loss, IoU, the U-Net++'s gradients, both modules'
    running statistics and the updated parameters, at test_torch_train's
    tolerances; with weak augmentation the JAX key's draws are injected
    into the port, which replays them on the masks.

    The step is ill-conditioned in the ISP's gradients (ROADMAP Queue 3's
    guidance): a 1e-7 relative nudge of the input moves the port's own by
    4.5e-2 (none) and 9e-3 (weak) of their scale, where the two packages
    happen to read 1.6e-4 and 3.1e-3 apart. So the ISP's gradients are
    held where the ISP acts alone, on the cotangent that the port's step
    handed its ISP: against JAX's ISP backward on it within GRAD_TOL or
    F64_FACTOR times JAX's distance from the port's float64 ISP backward
    on it, and no further from that float64 backward than GRAD_TOL or
    JAX is. (That cotangent has channel means near zero, the output
    BN's: the gradients are sums that cancel, and under weak
    augmentation JAX's float32 read 7.4e-3 from float64, the port's
    4.5e-3.)"""
    key, draws = weak_key() if aug == "weak" else (jax.random.key(1), None)
    if draws is not None:
        monkeypatch.setattr(augment.Weak, "draw",
                            staticmethod(lambda generator, x: draws))
    cfg = TrainConfig(task="segmentation", lr=LR, augmentation=aug)
    jstate, jmets, jgrads = jax_seg_step(cfg, seg_weights, seg_batch, key)

    proc = port_processing(seg_weights[0], camera_parameters=DRONE_CAM)
    clf = unetpp.UNetPlusPlus(**SEG_UNET, device="cpu")
    clf.load_state_dict(convert.unetpp_state_dict(seg_weights[1]))
    seen = {}

    def capture(module, args, out):
        out[0].register_hook(lambda g: seen.__setitem__("g", g))
    proc.register_forward_hook(capture)
    state = create_train_state(cfg, proc, clf)
    mets = make_train_step(cfg, proc, clf)(
        state, torch.from_numpy(seg_batch[0]),
        torch.from_numpy(seg_batch[1]), torch.Generator())
    assert abs(float(mets["loss"]) - float(jmets["loss"])) < LOSS_TOL
    assert float(mets["iou_score"]) == pytest.approx(
        float(jmets["iou_score"]), abs=1e-6)

    want = convert.unetpp_state_dict({"params": jgrads[1]})
    for k, p in clf.named_parameters():
        assert rel_err(p.grad, want[k]) < GRAD_TOL, (k, rel_err(p.grad,
                                                                want[k]))
    g = seen["g"]
    want = convert.isp_state_dict({"params": jax_isp_vjp(
        seg_weights, seg_batch[0], g.numpy())})
    p64 = port_processing(seg_weights[0], camera_parameters=DRONE_CAM)
    p64.double().train()(torch.from_numpy(seg_batch[0]).double())[0] \
        .backward(g.double())
    for (k, p), w64 in zip(proc.named_parameters(), p64.parameters()):
        flax_f64 = rel_err(want[k], w64.grad)
        assert rel_err(p.grad, w64.grad) <= max(GRAD_TOL, flax_f64), k
        assert rel_err(p.grad, want[k]) <= max(
            GRAD_TOL, F64_FACTOR * flax_f64), (k, rel_err(p.grad, want[k]))
    want_proc = convert.isp_state_dict({"params": jstate.proc_params,
                                        "batch_stats": jstate.proc_stats})
    want_clf = convert.unetpp_state_dict({"params": jstate.clf_params,
                                          "batch_stats": jstate.clf_stats})
    for module, want, tol in ((proc, want_proc, STATS_TOL),
                              (clf, want_clf, U_STATS_TOL)):
        for k, b in module.named_buffers():
            if "running" in k:
                assert rel_err(b, want[k]) < tol, (k, rel_err(b, want[k]))
    grads_as_port = {**convert.isp_state_dict({"params": jgrads[0]}),
                     **convert.unetpp_state_dict({"params": jgrads[1]})}
    check_params(proc, want_proc, grads_as_port, slack=2 * LR)
    check_params(clf, want_clf, grads_as_port, slack=2 * LR)


# --- the CLI and serving --------------------------------------------------

@pytest.fixture
def tiny_drone(monkeypatch):
    """SyntheticRawSegmentation(n=8, 64x64) in place of every dataset
    name in the CLI."""
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw:
                        SyntheticRawSegmentation(n=8, h=SIZE, w=SIZE,
                                                 seed=5))


@pytest.fixture(scope="module")
def jax_metric_rows(seg_weights, seg_batch):
    """The keys of the rows that JAX's CLI writes into metrics.jsonl for a
    segmentation epoch: ``train_`` and ``val_`` before the keys of its
    train and eval steps' metrics (raw2logit_tpu/training/train.py:504,
    523), from the steps run once on the narrow U-Net++."""
    cfg = jcore.TrainConfig(task="segmentation", lr=LR)
    raw, y = jnp.asarray(seg_batch[0]), jnp.asarray(seg_batch[1])
    proc = JaxProcessing(camera_parameters=DRONE_CAM)
    clf = junetpp.UNetPlusPlus(**SEG_UNET)
    state, tx = jcore.create_train_state(
        cfg, proc, clf, raw, jax.random.key(0),
        processor_variables=seg_weights[0],
        classifier_variables=seg_weights[1])
    _, train = jcore.make_train_step(cfg, proc, clf, tx, donate=False)(
        state, raw, y, jax.random.key(1))
    _, val = jcore.make_eval_step(cfg, proc, clf)(state, raw, y,
                                                 jax.random.key(2))
    return [sorted(f"train_{k}" for k in train),
            sorted(f"val_{k}" for k in val)]


def metric_keys(rows):
    return [sorted(k for k in r if k not in ("time", "step")) for r in rows]


def test_cli_segmentation_run_and_its_serving(tmp_path, monkeypatch,
                                              tiny_drone, jax_metric_rows):
    """A SyntheticDrone --test_run through the CLI: its metrics.jsonl rows
    carry the keys of JAX's (train_iou_score, val_iou_score, the losses),
    the run records no classes, and its checkpoints serve
    through ``Predictor.from_run`` (masks equal to the trained modules')
    and ``serving.main`` (one record per file with JAX's fields, their
    mask means the masks')."""
    monkeypatch.chdir(tmp_path)
    args = ["--dataset", "SyntheticDrone", "--epochs", "1", "--batch_size",
            "4", "--test_run", "--lr", "1e-3", "--experiment_name", "seg",
            "--run_name", "s"]
    (res,) = cli.main(args + ["--device", "cpu"])
    rows = res["run"].read_metrics()
    assert metric_keys(rows) == jax_metric_rows == [
        ["train_iou_score", "train_loss", "train_loss_aux"],
        ["val_iou_score", "val_loss"]]
    with open(os.path.join(res["run"].dir, "state_dict.json")) as fh:
        assert "classes" not in json.load(fh)
    clf = res["state"].classifier
    assert isinstance(clf, unetpp.UNetPlusPlus) and clf.encoder.fc is None

    img_dir = tmp_path / "dngs"
    img_dir.mkdir()
    ds = SyntheticRawSegmentation(n=3, h=SIZE, w=SIZE, seed=9)
    for i in range(3):
        dng.write_dng(str(img_dir / f"m{i}.dng"),
                      np.round(ds[i][0] * 65535).astype(np.uint16))
    pred = Predictor.from_run("seg", "s", dataset_name="SyntheticDrone",
                              image_size=SIZE, device="cpu", n=2)
    assert pred.task == "segmentation" and pred.classes is None
    raws = np.stack([dng.read_dng(str(img_dir / f"m{i}.dng")) / 65535.0
                     for i in range(3)]).astype(np.float32)
    proc, clf = res["state"].processor.eval(), clf.eval()
    with torch.no_grad():
        want = torch.sigmoid(clf(proc(torch.from_numpy(raws))[0]))
    got = pred(raws)
    assert got.shape == (3, 1, SIZE, SIZE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    out = serving.main(["--experiment_name", "seg", "--run_name", "s",
                        "--image_dir", str(img_dir), "--dataset",
                        "SyntheticDrone", "--batch_size", "2", "--out",
                        "p.jsonl", "--device", "cpu"])
    with open(out) as fh:
        records = [json.loads(line) for line in fh]
    assert [sorted(r) for r in records] == [
        ["file", "mask_mean", "mask_pixels"]] * 3
    for r, m in zip(records, want.numpy()):
        assert r["mask_mean"] == pytest.approx(float(m.mean()), abs=1e-6)


@pytest.fixture(scope="module")
def seg_run(tmp_path_factory):
    """A port segmentation run written from JAX variables (the drone ISP
    and the published U-Net++), and the JAX Predictor on the same
    weights."""
    root = str(tmp_path_factory.mktemp("segruns"))
    rng = np.random.default_rng(21)
    pv = jax_variables(DRONE_CAM, rng, perturb=True)
    jclf = junetpp.UNetPlusPlus(encoder_depth=5,
                                decoder_channels=(256, 128, 64, 32, 16),
                                classes=1)
    cv = random_variables(jclf, (1, SIZE, SIZE, 3), rng)
    proc = port_processing(pv, camera_parameters=DRONE_CAM)
    clf = unetpp.UNetPlusPlus(device="cpu")
    clf.load_state_dict(convert.unetpp_state_dict(cv))
    write_port_run(root, "e", "seg", {"processing_mode": "parametrized",
                                      "smp_encoder": "resnet34"},
                   {"processor": proc, "classifier": clf})
    write_port_run(root, "e", "seg18", {"processing_mode": "parametrized",
                                        "smp_encoder": "resnet18"},
                   {"processor": proc, "classifier": clf})
    jproc = JaxProcessing(camera_parameters=DRONE_CAM, use_pallas=True)
    return root, JaxPredictor(jproc, jclf, pv, cv, task="segmentation")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_from_run_segmentation_matches_jax(seg_run, use_kernel):
    """The run's ISP and U-Net++ served from their files give the JAX
    Predictor's masks on the same weights."""
    root, jpred = seg_run
    pred = Predictor.from_run("e", "seg", dataset_name="SyntheticDrone",
                              image_size=SIZE, root=root, device="cpu",
                              use_kernel=use_kernel, n=2)
    ds = SyntheticRawSegmentation(n=3, h=SIZE, w=SIZE, seed=6)
    raw = np.stack([ds[i][0] for i in range(3)])
    np.testing.assert_allclose(pred(raw).numpy(), nchw(jpred(raw)), rtol=0,
                               atol=LOGIT_ATOL)


def test_from_run_refuses_what_jax_cannot_serve(seg_run):
    """JAX's segmentation branch always builds a resnet34 U-Net++ and
    cannot restore another encoder's run; it has no branch for the neural
    and identity modes and feeds the raw mosaic to the task model. The
    port raises, naming ROADMAP Queue 3."""
    root, _ = seg_run
    with pytest.raises(ValueError, match="resnet18.*Queue 3"):
        Predictor.from_run("e", "seg18", dataset_name="SyntheticDrone",
                           root=root, device="cpu", n=2)
    for mode in ("neural_network", "none"):
        with pytest.raises(ValueError, match="Queue 3"):
            Predictor.from_run("e", "seg", dataset_name="SyntheticDrone",
                               processing_mode=mode, root=root,
                               device="cpu", n=2)


@pytest.mark.parametrize("mode", ["neural_network", "none"])
def test_cli_refuses_half_resolution_processors_for_segmentation(
        mode, tmp_path, monkeypatch, tiny_drone):
    """Both processors emit (H/2, W/2) RGB against (H, W) masks; JAX's
    run fails in its Dice loss (ROADMAP Queue 3), the port refuses before
    it trains."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="Queue 3"):
        cli.main(["--dataset", "SyntheticDrone", "--processing_mode", mode,
                  "--device", "cpu", "--test_run", "--batch_size", "4"])
