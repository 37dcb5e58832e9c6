"""The training CLI's ``--profile`` and ``--compute_dtype bfloat16`` in
the PyTorch port, on the CPU at 64x64.

``--profile`` (JAX ``training/train.py:487-501, 538-541``) traces global
train steps [1, 4) of a fold with ``torch.profiler`` into the run's
``profile/`` directory, also when training ends inside that window, with
the port's spans on for the window (its ``r2l.`` ranges), and changes
nothing that is trained: the run's metrics equal those of the same
run without the flag, bit for bit. ``--compute_dtype bfloat16`` trains
the task model in bfloat16 (the ISP stays float32) for classification,
segmentation and the adversarial step with a frozen classifier; its
checkpoints stay float32, so ``Predictor.from_run`` serves them as it
serves a float32 run.
"""

import json
import os

import pytest
import torch

from raw2logit_tpu_torch import serving, tracing
from raw2logit_tpu_torch.data import (SyntheticRawClassification,
                                      SyntheticRawSegmentation, datasets)
from raw2logit_tpu_torch.training import train as cli
# one torch thread: the runs here are compared bit for bit
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401

COMMON = ["--batch_size", "4", "--n_splits", "1", "--device", "cpu",
          "--lr", "1e-3"]


@pytest.fixture
def tiny(monkeypatch):
    """24 64x64 microscopy mosaics for every dataset name: 19 train, so
    4 steps per epoch."""
    data = SyntheticRawClassification(n=24, h=64, w=64, seed=5)
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw: data)
    monkeypatch.setattr(datasets, "get_dataset", lambda name, **kw: data)
    return data


def metrics(res):
    return [{k: v for k, v in row.items() if k != "time"}
            for row in res["run"].read_metrics()]


@pytest.mark.parametrize("epochs", [1, "test_run"],
                         ids=["four_steps", "ends_inside_window"])
def test_profile_writes_a_trace_and_changes_nothing(tmp_path, monkeypatch,
                                                    tiny, epochs):
    """Four steps (the window [1, 4) closes after step 3), or two test-run
    epochs of one step (training ends inside the window): a Chrome trace
    with events in the run's profile/ directory, and the metrics of the
    run without --profile."""
    monkeypatch.chdir(tmp_path)
    args = COMMON + ["--dataset", "SyntheticMicroscopy",
                     "--experiment_name", "p"]
    args += (["--epochs", "1"] if epochs == 1
             else ["--epochs", "2", "--test_run"])
    (plain,) = cli.main(args + ["--run_name", "plain"])
    (traced,) = cli.main(args + ["--run_name", "traced", "--profile"])
    path = os.path.join(traced["run"].dir, "profile", "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"r2l.step", "r2l.step.backward", "r2l.step.optimizer"} <= names
    assert tracing.span("r2l.step") is tracing.NOOP  # off after the window
    assert not os.path.exists(os.path.join(plain["run"].dir, "profile"))
    assert metrics(traced) == metrics(plain)
    assert traced["state"].step == plain["state"].step


def test_bf16_classification_run_serves_float32(tmp_path, monkeypatch,
                                                 tiny):
    monkeypatch.chdir(tmp_path)
    (res,) = cli.main(COMMON + ["--dataset", "SyntheticMicroscopy",
                                "--epochs", "1", "--test_run",
                                "--compute_dtype", "bfloat16",
                                "--experiment_name", "b", "--run_name",
                                "b"])
    clf = res["state"].classifier
    assert clf.dtype == torch.bfloat16
    assert res["state"].processor.debayer.weight.dtype == torch.float32
    saved = torch.load(os.path.join(res["run"].dir, "checkpoints",
                                    "classifier.pt"))
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in saved.values())
    pred = serving.Predictor.from_run("b", "b", dataset_name="x",
                                      image_size=64, use_kernel=False,
                                      device="cpu")
    assert pred.classifier.dtype == torch.float32
    out = pred(torch.stack([torch.as_tensor(tiny[i][0]) for i in range(2)]))
    assert len(out) == 2


def test_bf16_segmentation_and_attack_runs(tmp_path, monkeypatch):
    """A bfloat16 U-Net++ segmentation run, and an attack on gamma through
    a frozen bfloat16 classifier loaded from a pretraining run's float32
    file."""
    monkeypatch.chdir(tmp_path)
    drone = SyntheticRawSegmentation(n=8, h=64, w=64, seed=5)
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw: drone)
    bf16 = ["--compute_dtype", "bfloat16", "--epochs", "1", "--test_run"]
    (seg,) = cli.main(COMMON + bf16 + [
        "--dataset", "SyntheticDrone", "--smp_encoder", "resnet18",
        "--experiment_name", "s", "--run_name", "s"])
    assert seg["state"].classifier.dtype == torch.bfloat16
    assert all(m["train_loss"] == m["train_loss"]
               for m in seg["run"].read_metrics() if "train_loss" in m)
    micro = SyntheticRawClassification(n=8, h=64, w=64, seed=5)
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw: micro)
    (pre,) = cli.main(COMMON + bf16 + [
        "--dataset", "SyntheticMicroscopy", "--freeze_processor",
        "--experiment_name", "f", "--run_name", "pre"])
    clf_file = os.path.join(pre["run"].dir, "checkpoints", "classifier.pt")
    (adv,) = cli.main(COMMON + bf16 + [
        "--dataset", "SyntheticMicroscopy", "--adv_training",
        "--freeze_classifier", "--adv_parameters", "gamma_correct",
        "--classifier_uri", clf_file, "--experiment_name", "f",
        "--run_name", "adv"])
    rows = [m for m in adv["run"].read_metrics() if "val_loss_aux" in m]
    assert rows and adv["state"].classifier.dtype == torch.bfloat16
