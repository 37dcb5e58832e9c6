"""The port's staged train step (``make_staged_train_step``) against the
port's one step, its stages, its ``isp_residuals`` form, the training
CLI's ``--staged_step`` and ``--fuse_opt``, and the forensics driver with
JAX's command line. (Against the JAX package's staged step:
tests/test_torch_staged_jax.py; two ranks:
tests/test_torch_staged_parallel.py.) Imports no JAX: the two-rank
children import this module.

All on the CPU at a small size: B = 4 mosaics of 32x32, the ISP with its
output BN (the fused-kernel processor's wrappers run their plain versions
here), narrow ResNets and a narrow U-Net++. The staged step against the
one step holds every gradient leaf within atol 2e-5, rtol 2e-4, JAX's own
staged-against-monolith bound (tests/test_training.py:384-386).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from raw2logit_tpu_torch import tracing
from raw2logit_tpu_torch.data import (DRONE_CAMERA_PARAMS,
                                      MICROSCOPY_CAMERA_PARAMS,
                                      SyntheticRawClassification,
                                      SyntheticRawSegmentation)
from raw2logit_tpu_torch.examples import drift_forensics
from raw2logit_tpu_torch.isp import NNProcessing, ParametrizedProcessing
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_staged_train_step,
                                          make_train_step)
from raw2logit_tpu_torch.training import train as cli

LR = 1e-3
# staged against one step: gradient leaves and updated parameters (JAX's
# staged-vs-monolith bound), loss abs, accuracy or IoU abs; running
# statistics relative to their largest (tests/test_torch_train.py)
ATOL, RTOL, STEP_LOSS_TOL, METRIC_TOL = 2e-5, 2e-4, 1e-5, 1e-6
STATS_TOL = 1e-5
SIZE = 32


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs several test
    processes at once, and a thread pool per process the size of the
    machine oversubscribes its cores many times over (as in
    tests/test_torch_unetpp.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(got, want):
    """Max abs error over max |want|."""
    return float((got.double() - want.double()).abs().max()) / max(
        float(want.double().abs().max()), 1e-30)


def mosaics(task, n=4, seed=3):
    ds = (SyntheticRawClassification if task == "classification"
          else SyntheticRawSegmentation)(n=n, h=SIZE, w=SIZE, seed=seed)
    raw = torch.from_numpy(np.stack([ds[i][0] for i in range(n)]))
    y = torch.as_tensor(np.stack([ds[i][1] for i in range(n)]))
    return raw.float(), y


def modules(task, use_kernel, classifier="narrow", noise=False):
    """A seeded ISP (drone camera for segmentation) and task model: a
    narrow ResNet, a one-stage ResNet at the stem kernels' 64 filters
    (``stem``, float32 or ``stem_bf16``), or a narrow U-Net++."""
    proc = ParametrizedProcessing(
        DRONE_CAMERA_PARAMS if task == "segmentation"
        else MICROSCOPY_CAMERA_PARAMS, use_kernel=use_kernel,
        additive_layer=noise, image_size=SIZE, device="cpu")
    gen = torch.Generator().manual_seed(1)
    if task == "segmentation":
        clf = UNetPlusPlus("resnet18", 3, (32, 16, 8), classes=1,
                           device="cpu", generator=gen)
    elif classifier == "narrow":
        clf = resnet.ResNet(stage_sizes=(1, 1), num_filters=8,
                            num_classes=3, device="cpu", generator=gen)
    else:
        clf = resnet.ResNet(stage_sizes=(1,), num_classes=3, device="cpu",
                            generator=gen, stem_kernel=True,
                            dtype=(torch.bfloat16 if classifier == "stem_bf16"
                                   else torch.float32))
    return proc, clf


CASES = {
    "cls-plain": (dict(), False, "narrow"),
    "cls-kernel-weak": (dict(augmentation="weak"), True, "narrow"),
    "cls-kernel-strong-wd-cosine": (dict(augmentation="strong",
                                         weight_decay=1e-2,
                                         lr_schedule="cosine",
                                         total_steps=4), True, "narrow"),
    "cls-kernel-stem": (dict(), True, "stem"),
    "cls-kernel-stem-bf16": (dict(), True, "stem_bf16"),
    "seg-plain-weak": (dict(task="segmentation", augmentation="weak"),
                       False, "narrow"),
    "seg-kernel-weak": (dict(task="segmentation", augmentation="weak"),
                        True, "narrow"),
    "frozen-classifier-kernel": (dict(freeze_classifier=True), True,
                                 "narrow"),
    "frozen-processor-kernel": (dict(freeze_processor=True), True,
                                "narrow"),
    "adv-ssim-kernel": (dict(adv_training=True), True, "narrow"),
    "adv-ssim-plain": (dict(adv_training=True), False, "narrow"),
    "adv-l2-kernel": (dict(adv_training=True, adv_aux_loss="l2"), True,
                      "narrow"),
    "adv-gamma-kernel": (dict(adv_training=True,
                              adv_parameters="gamma_correct"), True,
                         "narrow"),
    "adv-additive-kernel": (dict(adv_training=True,
                                 adv_parameters="additive_layer"), True,
                            "narrow"),
}


def run(kind, case, steps=2):
    """``steps`` steps of the one step (``one``) or the staged step
    (``staged``, ``fused``) on case ``case``: (each step's metrics as
    floats, the gradients of the last step, the modules' state dicts)."""
    kwargs, use_kernel, classifier = CASES[case]
    cfg = TrainConfig(lr=LR, **kwargs)
    if cfg.adv_training:
        cfg = dataclasses.replace(cfg, freeze_classifier=True,
                                  loss_weight=-1.0, adv_aux_weight=-0.7)
    proc, clf = modules(cfg.task, use_kernel, classifier,
                        noise=cfg.adv_parameters == "additive_layer")
    state = create_train_state(cfg, proc, clf, split_opt=kind == "fused")
    if cfg.adv_training:  # the attacked ISP away from the reference
        with torch.no_grad():
            for i, p in enumerate(proc.parameters()):
                p.add_(0.01 * (-1) ** i)
    step = (make_train_step(cfg, proc, clf) if kind == "one" else
            make_staged_train_step(cfg, proc, clf, fuse_opt=kind == "fused"))
    raw, y = mosaics(cfg.task)
    gen = torch.Generator().manual_seed(5)
    mets = [{k: float(v) for k, v in step(state, raw, y, gen).items()}
            for _ in range(steps)]
    grads = {f"{m}.{n}": p.grad.clone()
             for m, module in (("isp", proc), ("clf", clf))
             for n, p in module.named_parameters() if p.grad is not None}
    sd = {f"{m}.{n}": t.clone()
          for m, module in (("isp", proc), ("clf", clf))
          for n, t in module.state_dict().items()}
    return mets, grads, sd, state


def allclose(got, want):
    return bool(torch.allclose(got.double(), want.double(), rtol=RTOL,
                               atol=ATOL))


@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_step_matches_one_step(case):
    """Two steps of the staged step, with and without ``fuse_opt``, from
    the same weights, batch and generator as two of the one step: loss,
    accuracy or IoU, every gradient leaf of the second step, and every
    parameter and running statistic after it."""
    mets, grads, sd, state = run("one", case)
    for kind in ("staged", "fused"):
        got_mets, got_grads, got_sd, got_state = run(kind, case)
        assert got_state.step == state.step == 2
        for got, want in zip(got_mets, mets):
            assert got.keys() == want.keys()
            assert abs(got["loss"] - want["loss"]) < STEP_LOSS_TOL, kind
            assert abs(got["loss_aux"] - want["loss_aux"]) < STEP_LOSS_TOL
            for k in ("accuracy", "iou_score"):
                if k in want:
                    assert abs(got[k] - want[k]) < METRIC_TOL, (kind, k)
        assert got_grads.keys() == grads.keys(), kind
        for name, g in grads.items():
            assert allclose(got_grads[name], g), (kind, name)
        for name, t in sd.items():
            if "running" in name:
                assert rel_err(got_sd[name], t) < STATS_TOL, (kind, name)
            else:
                assert allclose(got_sd[name], t), (kind, name)


def test_staged_step_stages_and_records():
    """``step.programs`` names JAX's programs (clf_grad_bn with the
    train-mode output BN, aux_grad in adversarial mode, no opt_apply with
    fuse_opt), and with tracing on a profile of one step holds a span
    ``r2l.staged.<stage>`` of each stage that ran, as the port's own
    record does."""
    proc, clf = modules("classification", True)
    cfg = TrainConfig(lr=LR)
    step = make_staged_train_step(cfg, proc, clf)
    assert sorted(step.programs) == ["clf_grad", "clf_grad_bn", "isp_bwd",
                                     "isp_fwd", "opt_apply"]
    assert not step.fuse_opt and not step.isp_residuals
    adv = make_staged_train_step(dataclasses.replace(
        cfg, adv_training=True), proc, clf, fuse_opt=True)
    assert sorted(adv.programs) == ["aux_grad", "clf_grad", "isp_bwd",
                                    "isp_fwd"]
    state = create_train_state(cfg, proc, clf)
    raw, y = mosaics("classification")
    ran = {f"r2l.staged.{n}" for n in ("isp_fwd", "clf_grad_bn", "isp_bwd",
                                        "opt_apply")}
    tracing.enable()
    try:
        with torch.profiler.profile() as prof:
            step(state, raw, y)
    finally:
        spans = tracing.disable()
    names = {e.name for e in prof.events()}
    assert ran <= names
    assert {s.name for s in spans} == ran


def test_fuse_opt_refuses_a_joint_state():
    """fuse_opt steps a split state's pair and raises on a joint
    optimizer (tests/test_training.py:894-905); the one step and the
    unfused staged step raise on a split state."""
    proc, clf = modules("classification", False)
    cfg = TrainConfig(lr=LR)
    raw, y = mosaics("classification")
    joint = create_train_state(cfg, proc, clf)
    with pytest.raises(ValueError, match="split_opt=True"):
        make_staged_train_step(cfg, proc, clf, fuse_opt=True)(joint, raw, y)
    split = create_train_state(cfg, proc, clf, split_opt=True)
    for step in (make_train_step(cfg, proc, clf),
                 make_staged_train_step(cfg, proc, clf)):
        with pytest.raises(ValueError, match="fuse_opt=True"):
            step(split, raw, y)


def test_isp_residuals_equals_recompute():
    """``isp_residuals=True`` with the neural ISP backpropagates through
    the graph its forward kept: its gradients equal the recomputing staged
    step's within 1e-6 (tests/test_training.py:957-997), its loss
    bitwise, and its running statistics move once."""
    out = {}
    for residuals in (False, True):
        proc = NNProcessing(normalize_mosaic_mean=(0.5, 0.5, 0.5),
                            normalize_mosaic_std=(0.25, 0.25, 0.25),
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))
        clf = resnet.ResNet(stage_sizes=(1,), num_filters=8, num_classes=2,
                            device="cpu")
        cfg = TrainConfig(lr=LR)
        state = create_train_state(cfg, proc, clf)
        step = make_staged_train_step(cfg, proc, clf,
                                      isp_residuals=residuals)
        assert step.isp_residuals == residuals
        raw = torch.from_numpy(np.random.default_rng(0).uniform(
            size=(2, SIZE, SIZE)).astype(np.float32))
        mets = step(state, raw, torch.tensor([0, 1]))
        out[residuals] = (float(mets["loss"]),
                          {n: p.grad for n, p in proc.named_parameters()},
                          {n: b for n, b in proc.named_buffers()})
    (loss, grads, bufs), (loss_r, grads_r, bufs_r) = out[False], out[True]
    assert loss == loss_r
    for name, g in grads.items():
        assert float((grads_r[name] - g).abs().max()) <= 1e-6, name
    for name, b in bufs.items():
        assert torch.equal(bufs_r[name], b), name
    assert int(bufs["model.encoder.bn1.num_batches_tracked"]) == 1


# --- the CLI ----------------------------------------------------------------

@pytest.fixture
def tiny_dataset(monkeypatch):
    """SyntheticRawClassification(n=8, h=64, w=64) for every dataset name
    (tests/test_torch_cli.py)."""
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw:
                        SyntheticRawClassification(n=8, h=64, w=64, seed=5))


CLI_ARGS = ["--dataset", "SyntheticMicroscopy", "--batch_size", "4",
            "--device", "cpu", "--lr", "1e-3", "--epochs", "2", "--test_run",
            "--use_pallas"]


def cli_classifier(flags, name):
    (res,) = cli.main(CLI_ARGS + ["--run_name", name] + flags)
    path = os.path.join(res["run"].dir, "checkpoints", "classifier.pt")
    return torch.load(path, weights_only=True), res


@pytest.mark.parametrize("flags", [["--staged_step"],
                                   ["--staged_step", "--fuse_opt"]],
                         ids=["staged", "staged_fuse_opt"])
def test_cli_staged_step_trains_as_the_one_step(flags, tmp_path, monkeypatch,
                                                tiny_dataset):
    """A --test_run with --staged_step (and --fuse_opt) writes the
    classifier file of the one-step run within the step tolerances."""
    monkeypatch.chdir(tmp_path)
    want, _ = cli_classifier(["--augmentation", "weak"], "one")
    got, res = cli_classifier(flags + ["--augmentation", "weak"], "staged")
    assert res["state"].step == 2
    assert isinstance(res["state"].optimizer, tuple) == ("--fuse_opt" in flags)
    for name, t in want.items():
        assert allclose(got[name], t), name


def test_cli_fuse_opt_needs_staged_step(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match="--fuse_opt requires --staged_step"):
        cli.main(["--dataset", "SyntheticMicroscopy", "--device", "cpu",
                  "--fuse_opt"])


def test_cli_fuse_opt_resumes(tmp_path, monkeypatch, tiny_dataset):
    """A --staged_step --fuse_opt run resumes from its periodic checkpoint
    (the split state's two optimizers) and ends within the step
    tolerances of the uninterrupted run (as in the JAX CLI, a resumed
    epoch restarts the loader's shuffle, so the batch's rows come in
    another order); a run without --fuse_opt cannot resume from it."""
    monkeypatch.chdir(tmp_path)
    flags = ["--staged_step", "--fuse_opt", "--checkpoint_every_n_epochs",
             "1"]
    want, _ = cli_classifier(flags, "whole")
    args = CLI_ARGS + ["--run_name", "r"] + flags
    cli.main(args + ["--epochs", "1"])
    (res,) = cli.main(args + ["--resume"])
    assert res["state"].step == 2
    got = torch.load(os.path.join(res["run"].dir, "checkpoints",
                                  "classifier.pt"), weights_only=True)
    for name, t in want.items():
        assert allclose(got[name], t), name
    with pytest.raises(ValueError, match="same --fuse_opt"):
        cli.main(CLI_ARGS + ["--run_name", "r", "--staged_step",
                             "--resume"])


def test_forensics_driver_takes_the_jax_command_line(tmp_path, monkeypatch,
                                                     tiny_dataset):
    """The JAX forensics driver's command line for the fused kernels,
    ``--use_pallas --staged_step`` (examples/drift_forensics.py:42-43),
    passes through the port's driver to the CLI: the attack on gamma
    reports what it reports with the one step."""
    monkeypatch.chdir(tmp_path)
    reports = [drift_forensics.run_forensics(
        targets=("gamma_correct",), pre_epochs=1, adv_epochs=2,
        batch_size=4, out_dir=f"out{i}",
        extra=["--device", "cpu", "--use_pallas"] + flags)[0]
        for i, flags in enumerate(([], ["--staged_step"]))]
    assert reports[1].keys() == reports[0].keys()
    for key, want in reports[0].items():
        if isinstance(want, float):
            assert abs(reports[1][key] - want) <= ATOL, key
        elif key != "stage_artifacts":
            assert reports[1][key] == want, key
