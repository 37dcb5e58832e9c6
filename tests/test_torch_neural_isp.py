"""PyTorch port vs the JAX package: the identity ISP (``isp/identity.py``,
``RawToRGB``) and the neural ISP (``isp/neural.py``, ``NNProcessing``:
packing, mosaic normalisation, U-Net++, output batch norm), their stages,
a neural-ISP classification train step against JAX's ``make_train_step``,
and the training CLI's ``neural_network`` and ``none`` modes.

All on the CPU: mosaics of 64x64 (32x32 after packing), the neural ISP at
its published widths (resnet34 encoder, depth 3, decoder (256, 128, 64)),
weights carried across by ``raw2logit_tpu_torch.convert``. Also the
float32-against-float64 gap of ``NNProcessing`` at ``chip_smoke.py``'s
shape, from which its card tolerance comes.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.isp import NNProcessing as JaxNN
from raw2logit_tpu.isp import RawToRGB as JaxRawToRGB
from raw2logit_tpu.models import resnet as jresnet
from raw2logit_tpu.training import core as jcore
from raw2logit_tpu.training import train as jcli

from chip_smoke import NN_F64_REL
from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.data import (SyntheticRawClassification,
                                      dataset_stats)
from raw2logit_tpu_torch.isp import NNProcessing, RawToRGB
from raw2logit_tpu_torch.models import resnet
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from raw2logit_tpu_torch.training import train as cli
from test_torch_isp import rel_err
from test_torch_resnet import LOGIT_ATOL
from test_torch_train import GRAD_TOL, LOSS_TOL, STATS_TOL
from test_torch_unetpp import (F64_FACTOR, U_STATS_TOL, nchw,
                               one_torch_thread,  # noqa: F401 (autouse)
                               random_variables)

SIZE = 64
STATS = dataset_stats("Microscopy")
MOSAIC = {"normalize_mosaic_mean": STATS["mosaic_mean"],
          "normalize_mosaic_std": STATS["mosaic_std"]}
# packing and one affine map in float32, two implementations
PACK_ATOL = 1e-6
# the train step: the output BN subtracts each channel's batch mean, so
# the gradient of the U-Net++ head's bias is zero, and float64 reads it
# as rounding, below this share of the neural ISP's largest gradient
# (it read 6.4e-17, under float64's epsilon of 2.2e-16)
ZERO_GRAD_REL = 1e-14
ZERO_GRAD = "model.segmentation_head.bias"


def mosaics(b=2, size=SIZE, seed=3):
    ds = SyntheticRawClassification(n=b, h=size, w=size, seed=seed)
    return np.stack([ds[i][0] for i in range(b)])


@pytest.mark.parametrize("normalise", [False, True])
def test_raw_to_rgb_matches_jax(normalise):
    """Output and its one stage within PACK_ATOL (JAX at the CLI's
    ``reduce_size=True, out_channels=3``); the ``demosaic`` stage is
    recorded before the normalisation, as in JAX."""
    kw = MOSAIC if normalise else {}
    raw = mosaics()
    want, wstages = JaxRawToRGB(reduce_size=True, out_channels=3,
                                **kw).apply({}, raw)
    got, stages = RawToRGB(**kw, device="cpu")(torch.from_numpy(raw))
    assert list(stages) == list(wstages) == ["demosaic"]
    np.testing.assert_allclose(got.numpy(), nchw(want), rtol=0,
                               atol=PACK_ATOL)
    np.testing.assert_allclose(stages["demosaic"].numpy(),
                               nchw(wstages["demosaic"]), rtol=0,
                               atol=PACK_ATOL)
    assert got.shape == (2, 3, SIZE // 2, SIZE // 2)
    assert torch.equal(stages["demosaic"], got) != normalise
    assert RawToRGB(**kw, device="cpu").state_dict() == {}


@pytest.mark.parametrize("normalise", [False, True])
def test_neural_isp_input_is_the_identity_isps_output(normalise):
    """The two ISPs pack and normalise alike, and differ in where they
    record the ``demosaic`` stage: the neural ISP's (its U-Net++ input)
    is bitwise the identity ISP's output, after the normalisation."""
    kw = MOSAIC if normalise else {}
    raw = torch.from_numpy(mosaics())
    rgb, _ = RawToRGB(**kw, device="cpu")(raw)
    with torch.no_grad():
        _, stages = NNProcessing(**kw, device="cpu").eval()(raw)
    assert torch.equal(stages["demosaic"], rgb)


@pytest.fixture(scope="module")
def nn_pair():
    """(flax NNProcessing with the microscopy mosaic statistics, its
    random variables with non-trivial output-BN statistics, the port's
    with them)."""
    rng = np.random.default_rng(31)
    fmodel = JaxNN(**MOSAIC)
    variables = random_variables(fmodel, (1, SIZE, SIZE), rng)
    pmodel = NNProcessing(**MOSAIC, device="cpu")
    pmodel.load_state_dict(convert.nn_isp_state_dict(variables))
    return fmodel, variables, pmodel


def test_nn_processing_tree_matches_flax_one_to_one(nn_pair):
    """Every flax leaf on exactly one port parameter or buffer of its
    shape, nothing else in the port (the mosaic statistics are not
    saved, as in JAX, where they are module arguments)."""
    _, variables, pmodel = nn_pair
    sd = convert.nn_isp_state_dict(variables)
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) \
        == len(jax.tree_util.tree_leaves(variables))
    got = {k: tuple(v.shape) for k, v in pmodel.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    assert {"batch_norm.running_mean", "batch_norm.running_var"} <= set(got)
    assert pmodel.model.encoder.fc is None
    assert not any(k.startswith("model.encoder.layer3") for k in got)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_nn_processing_matches_flax(nn_pair, train):
    """RGB (B, 3, H/2, W/2) and both stages at LOGIT_ATOL, the stages in
    JAX's order (the normalised packing, then the output); in train mode
    every running statistic of the U-Net++ and of the output BN after
    the forward."""
    fmodel, variables, pmodel = nn_pair
    raw = mosaics()
    before = copy.deepcopy(pmodel.state_dict())
    pmodel.train(train)
    with torch.no_grad():
        got, stages = pmodel(torch.from_numpy(raw))
    if train:
        (want, wstages), mut = fmodel.apply(variables, raw, train=True,
                                            mutable=["batch_stats"])
        stats = convert.nn_isp_state_dict(
            {"params": variables["params"],
             "batch_stats": jax.device_get(mut["batch_stats"])})
        for k, b in pmodel.named_buffers():
            if "running" in k:
                tol = STATS_TOL if k.startswith("batch_norm") else \
                    U_STATS_TOL
                assert rel_err(b, stats[k]) < tol, (k, rel_err(b, stats[k]))
        pmodel.load_state_dict(before)
    else:
        want, wstages = fmodel.apply(variables, raw, train=False)
    assert list(stages) == list(wstages) == ["demosaic", "rgb"]
    assert got.shape == (2, 3, SIZE // 2, SIZE // 2)
    assert stages["rgb"] is got
    for g, w in ((got, want), (stages["demosaic"], wstages["demosaic"])):
        np.testing.assert_allclose(g.numpy(), nchw(w), rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_nn_processing_float32_gap_within_the_card_tolerance(train):
    """The port's float32 NNProcessing against its float64 self on the
    CPU, at chip_smoke.py's shape (B = 4, 256x256 SyntheticMicroscopy
    mosaics, the CLI's mosaic statistics): max |difference| over max
    |float64| read 8.4e-7 (eval) and 1.08e-6 (train) when NN_F64_REL was
    set at ten times that; the card's float32 is held to NN_F64_REL."""
    m = NNProcessing(**MOSAIC, device="cpu")
    m64 = copy.deepcopy(m).double()
    raw = torch.from_numpy(mosaics(4, 256, seed=0))
    with torch.no_grad():
        got = m.train(train)(raw)[0].double()
        want = m64.train(train)(raw.double())[0]
    assert rel_err(got, want) <= NN_F64_REL / 5, rel_err(got, want)


# --- a neural-ISP train step ----------------------------------------------

@pytest.fixture(scope="module")
def clf_weights():
    rng = np.random.default_rng(32)
    clf = jresnet.ResNet(block_cls=jresnet.BasicBlock,
                         stage_sizes=(1, 1, 1, 1), num_filters=8,
                         num_classes=2)
    return random_variables(clf, (1, SIZE // 2, SIZE // 2, 3), rng)


def test_neural_isp_train_step_matches_jax(nn_pair, clf_weights):
    """NNProcessing -> narrow ResNet -> cross-entropy, one Adam step from
    the same weights: loss, accuracy, the gradients of both modules and
    their running statistics, at test_torch_train's tolerances (the
    U-Net++'s statistics at U_STATS_TOL). The gradients are held to JAX
    within GRAD_TOL or F64_FACTOR times JAX's distance from the port's
    float64 step, the port's no further from it than GRAD_TOL or JAX's
    (the float32 step is ill-conditioned, ROADMAP Queue 3's guidance).
    Each tensor's error is over its own max |float64 gradient|. The head
    bias of the U-Net++ (ZERO_GRAD) has none: its float64 gradient is
    held to zero within ZERO_GRAD_REL of the module's largest instead."""
    fmodel, pv, _ = nn_pair
    raw, y = mosaics(), np.array([0, 1])
    cfg = TrainConfig(lr=1e-3)
    jclf = jresnet.ResNet(block_cls=jresnet.BasicBlock,
                          stage_sizes=(1, 1, 1, 1), num_filters=8,
                          num_classes=2)
    jcfg = jcore.TrainConfig(lr=1e-3)
    state, tx = jcore.create_train_state(
        jcfg, fmodel, jclf, jnp.asarray(raw), jax.random.key(0),
        processor_variables=pv, classifier_variables=clf_weights)
    key = jax.random.key(1)

    @jax.jit
    def grads(state):
        def loss_fn(trainable):
            logits = jcore._forward(jcfg, fmodel, jclf, trainable[0],
                                    state.proc_stats, trainable[1],
                                    state.clf_stats, raw, key, True)[0]
            return jcore.task_loss_fn(jcfg)(logits, y)
        return jax.grad(loss_fn)((state.proc_params, state.clf_params))

    jg = jax.device_get(grads(state))
    jstate, jmets = jcore.make_train_step(jcfg, fmodel, jclf, tx,
                                          donate=False)(state, raw, y, key)
    jstate = jax.device_get(jstate)

    runs = {}
    for dtype in (torch.float32, torch.float64):
        proc = NNProcessing(**MOSAIC, device="cpu")
        proc.load_state_dict(convert.nn_isp_state_dict(pv))
        clf = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                            num_classes=2, device="cpu")
        clf.load_state_dict(convert.resnet_state_dict(clf_weights))
        proc, clf = proc.to(dtype), clf.to(dtype)
        state = create_train_state(cfg, proc, clf)
        mets = make_train_step(cfg, proc, clf)(
            state, torch.from_numpy(raw).to(dtype), torch.from_numpy(y))
        runs[dtype] = proc, clf, mets
    proc, clf, mets = runs[torch.float32]
    assert abs(float(mets["loss"]) - float(jmets["loss"])) < LOSS_TOL
    assert float(mets["accuracy"]) == float(jmets["accuracy"])

    wants = (convert.nn_isp_state_dict({"params": jg[0]}),
             convert.resnet_state_dict({"params": jg[1]}))
    for i, (module, want) in enumerate(zip((proc, clf), wants)):
        f64 = {k: p.grad.numpy() for k, p in
               runs[torch.float64][i].named_parameters()}
        largest = max(np.abs(g).max() for g in f64.values())

        def err(a, b, k):
            return float(np.abs(np.asarray(a, np.float64) - b).max()) / float(
                np.abs(f64[k]).max())
        for k, p in module.named_parameters():
            if i == 0 and k == ZERO_GRAD:
                assert np.abs(f64[k]).max() <= ZERO_GRAD_REL * largest
                continue
            flax_f64 = err(want[k], f64[k], k)
            assert err(p.grad, f64[k], k) <= max(GRAD_TOL, flax_f64), k
            assert err(p.grad, want[k].numpy(), k) <= max(
                GRAD_TOL, F64_FACTOR * flax_f64), k
    want_stats = {
        **convert.nn_isp_state_dict({"params": {},
                                     "batch_stats": jstate.proc_stats}),
        **{f"clf.{k}": v for k, v in convert.resnet_state_dict(
            {"params": {}, "batch_stats": jstate.clf_stats}).items()}}
    for prefix, module in (("", proc), ("clf.", clf)):
        for k, b in module.named_buffers():
            if "running" in k:
                tol = STATS_TOL if k.startswith("batch_norm") or prefix \
                    else U_STATS_TOL
                assert rel_err(b, want_stats[prefix + k]) < tol, k


# --- the CLI --------------------------------------------------------------

@pytest.fixture
def tiny_microscopy(monkeypatch):
    """SyntheticRawClassification(n=8, 64x64) in place of every dataset
    name, in both packages' CLIs."""
    from raw2logit_tpu.data import datasets as jdatasets
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw:
                        SyntheticRawClassification(n=8, h=SIZE, w=SIZE,
                                                   seed=5))
    monkeypatch.setattr(jcli, "get_dataset", lambda name, **kw:
                        jdatasets.SyntheticRawClassification(
                            n=8, h=SIZE, w=SIZE, seed=5))


def metric_keys(run):
    return [sorted(k for k in r if k not in ("time", "step"))
            for r in run.read_metrics()]


def test_cli_neural_and_identity_runs(tmp_path, monkeypatch,
                                      tiny_microscopy):
    """--processing_mode neural_network and none through the port's CLI
    (a 2-epoch --test_run each, one step per epoch): metrics rows with
    the JAX CLI's keys (its identity run's: the keys are the task's,
    whatever the processor); the neural run saves both modules, and every
    parameter and running statistic of both moved from the init the CLI
    drew (the first step leaves the convolutions before the zero-scaled
    last BN of each residual block alone, the second moves them); the
    identity run has no processor file, its processor no parameters."""
    monkeypatch.chdir(tmp_path)
    common = ["--dataset", "SyntheticMicroscopy", "--epochs", "2",
              "--batch_size", "4", "--test_run", "--lr", "1e-3",
              "--experiment_name", "n"]
    (jres,) = jcli.main(common + ["--processing_mode", "none",
                                  "--run_name", "j"])
    want_keys = metric_keys(jres["run"])
    assert want_keys == 2 * [
        ["train_accuracy", "train_loss", "train_loss_aux"],
        ["val_accuracy", "val_loss"]]
    runs = {}
    for mode in ("neural_network", "none"):
        (runs[mode],) = cli.main(common + ["--processing_mode", mode,
                                           "--run_name", mode, "--device",
                                           "cpu"])
        assert metric_keys(runs[mode]["run"]) == want_keys

    res = runs["neural_network"]
    assert sorted(os.listdir(os.path.join(res["run"].dir, "checkpoints"))) \
        == ["classifier.pt", "processor.pt"]
    args = cli.build_parser().parse_args(
        common + ["--processing_mode", "neural_network"])
    dataset = cli.get_dataset(args.dataset)
    init = torch.Generator().manual_seed(args.seed)
    starts = (cli.build_processor(args, dataset, SIZE, "cpu", init),
              cli.build_classifier(args, dataset, "cpu", init))
    assert isinstance(starts[0], NNProcessing)
    for module, start in zip((res["state"].processor,
                              res["state"].classifier), starts):
        start = start.state_dict()
        for k, t in module.state_dict().items():
            if t.is_floating_point():
                assert not torch.equal(t, start[k]), k

    res = runs["none"]
    assert os.listdir(os.path.join(res["run"].dir, "checkpoints")) == [
        "classifier.pt"]
    assert isinstance(res["state"].processor, RawToRGB)
    assert list(res["state"].processor.parameters()) == []
