"""The port's evaluation CLI (``python -m
raw2logit_tpu_torch.figures.ABtesting``, all eight modes), its figure CLI
(``python -m raw2logit_tpu_torch.figures.figures``), ``save_image_grid``
and ``evaluation/figures.py``, on the CPU (``--device cpu``) at 32x32; the
grids and the tables held to the JAX package's (the same PNG pixels; the
JAX renderers read the port's tables).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from raw2logit_tpu.evaluation import abtesting as jab
from raw2logit_tpu.tracking.images import save_image_grid as jax_grid

from raw2logit_tpu_torch.data import SyntheticRawClassification
from raw2logit_tpu_torch.evaluation import abtesting as pab
from raw2logit_tpu_torch.evaluation.figures import (loss_scatter,
                                                    make_stage_gif, show_img)
from raw2logit_tpu_torch.figures import ABtesting as cli
from raw2logit_tpu_torch.figures import figures as fig_cli
from raw2logit_tpu_torch.models import resnet_model
from raw2logit_tpu_torch.tracking.images import save_image_grid
from raw2logit_tpu_torch.training.checkpoint import save_module

ROWS = [("bilinear", "sharpening_filter", "gaussian_denoising"),
        ("malvar2004", "unsharp_masking", "median_denoising")]


def pixels(path):
    return np.asarray(Image.open(path))


@pytest.mark.parametrize("shape", [(3, 3, 16, 20), (10, 1, 8, 8),
                                   (2, 12, 9)])
def test_image_grid_is_jax_s(shape, tmp_path):
    """NCHW (or B, H, W) in, the JAX package's NHWC grid out, pixel for
    pixel, clipped (values outside [0, 1] included)."""
    x = np.random.default_rng(0).uniform(-0.2, 1.2, shape).astype(
        np.float32)
    save_image_grid(torch.from_numpy(x), str(tmp_path / "port.png"), nrow=4)
    jax_grid(x if x.ndim == 3 else np.moveaxis(x, 1, -1),
             str(tmp_path / "jax.png"), nrow=4)
    np.testing.assert_array_equal(pixels(tmp_path / "port.png"),
                                  pixels(tmp_path / "jax.png"))


def write_run(run_dir, epochs=3):
    os.makedirs(run_dir)
    with open(os.path.join(run_dir, "metrics.jsonl"), "w") as fh:
        for e in range(epochs):
            fh.write(json.dumps({"step": e, "train_loss": 1.0 / (e + 1)})
                     + "\n")
            fh.write(json.dumps({"step": e, "val_loss": 1.1 / (e + 1)})
                     + "\n")
    rng = np.random.default_rng(0)
    for e in (1, 2):
        d = os.path.join(run_dir, "results", f"epoch_{e:04d}")
        os.makedirs(d)
        save_image_grid(rng.uniform(size=(2, 3, 16, 16)), os.path.join(
            d, "img_processing_0_gamma_correct.png"))


def test_loss_scatter_gif_and_show_img(tmp_path):
    run_dir = str(tmp_path / "run")
    write_run(run_dir)
    assert os.path.getsize(loss_scatter(run_dir)) > 0
    gif = make_stage_gif(run_dir, stage="gamma_correct", mode="processing")
    assert gif.endswith(".gif") and os.path.getsize(gif) > 0
    with pytest.raises(FileNotFoundError):
        make_stage_gif(run_dir, stage="demosaic")
    out = show_img(np.random.default_rng(1).uniform(size=(8, 8, 3)),
                   title="t", out_path=str(tmp_path / "s" / "img.png"))
    assert os.path.getsize(out) > 0


def test_figures_cli_resolves_runs(tmp_path, monkeypatch, capsys):
    """--run_dir, and the reference's --experiment_name/--run_name against
    the run store (a parent run resolves to its first fold), both
    outputs."""
    monkeypatch.chdir(tmp_path)
    write_run(os.path.join("results", "runs", "e", "r", "r_0"))
    fig_cli.main(["--experiment_name", "e", "--run_name", "r", "--output",
                  "gif", "--gif_name", "g"])
    assert os.path.exists("results/runs/e/r/r_0/g.gif")
    fig_cli.main(["--run_dir", "results/runs/e/r/r_0", "--scatter"])
    assert os.path.exists("results/runs/e/r/r_0/loss_scatter.png")
    with pytest.raises(SystemExit):
        fig_cli.main(["--run_dir", "results/runs/e/r/r_0"])
    assert "wrote" in capsys.readouterr().out


@pytest.fixture
def cli_setup(tmp_path, monkeypatch):
    """A 32x32 SyntheticMicroscopy of 6 for the CLI's dataset, two
    classifiers (ROWS: a seeded one, then it with its head negated; one
    random init of ResNet-18, the costliest call here on a loaded CPU),
    their --checkpoints_json (plain and as a sweep manifest) and a
    --state_dict; in a temporary directory, with one torch thread (on a
    loaded CPU the test's many small ops otherwise wait on each other's
    threads)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pab, "get_dataset", lambda name, **kw:
                        SyntheticRawClassification(n=6, h=32, w=32, seed=3))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ckpts = {}
    model = resnet_model(device="cpu",
                         generator=torch.Generator().manual_seed(0))
    for i, pip in enumerate(ROWS):
        if i:
            with torch.no_grad():
                model.fc.weight.neg_()
        ckpts[pab.pipeline_name(*pip)] = [save_module(
            model, f"runs/{i}/checkpoints/classifier.pt")]
    with open("state_dict.json", "w") as fh:
        json.dump({"valid_indices": [0, 3, 4]}, fh)
    with open("ckpts.json", "w") as fh:
        json.dump(ckpts, fh)
    with open("manifest.json", "w") as fh:
        json.dump({"jobs": [], "checkpoints": ckpts, "state_dicts": {
            "x": [os.path.abspath("state_dict.json")]}}, fh)
    yield ["--dataset_name", "Tiny", "--out_dir", "ab", "--device", "cpu",
           "--batch_size", "2"]
    torch.set_num_threads(threads)


def test_cli_runs_its_eight_modes_on_the_cpu(cli_setup):
    """Each mode writes what it should: the tables (the JAX package's
    renderers read them too), their heatmaps, the panels and the
    galleries."""
    common = cli_setup
    cli.main(["--mode", "ABMakeTable", "--checkpoints_json", "ckpts.json",
              "--state_dict", "state_dict.json"] + common)
    with open("ab/tables/ABtable_Tiny_weak.json") as fh:
        ab = json.load(fh)
    assert len(ab) == 1 + 2 * 12 and ab["_meta"]["n_runs"] == 5
    assert all(v["n_runs"] == 1 for k, v in ab.items() if k != "_meta")
    # the manifest form reads its own state dicts
    cli.main(["--mode", "CMakeTable", "--checkpoints_json", "manifest.json",
              "--severities", "1", "3"] + common)
    with open("ab/tables/Ctable_Tiny_weak.json") as fh:
        c = json.load(fh)
    assert len(c) == 1 + 2 * len(pab.CORRUPTION_LIST) * 2
    assert c["_meta"]["valid_indices_hash"] == ab["_meta"][
        "valid_indices_hash"]
    for mode in ("ABShowTable", "CShowTable"):
        cli.main(["--mode", mode] + common)
    # the JAX package's renderers read the port's tables
    for which, show in (("AB", jab.ab_show_table), ("C", jab.c_show_table)):
        assert os.path.getsize(f"ab/tables/{which}table_Tiny_weak.png") > 0
        show(f"ab/tables/{which}table_Tiny_weak.json",
             out_png=f"{which}_jax.png")
        assert os.path.getsize(f"{which}_jax.png") > 0
    cli.main(["--mode", "ABShowImages", "--checkpoints_json", "ckpts.json",
              "--dm_test", "menon2007", "--s_test", "unsharp_masking"]
             + common)
    panel = "ab/imgs/Tiny_weak_bisga_meuga"
    assert {"img_train.png", "img_test.png", "diff_Blue.png",
            "logdiff_Red.png", "predictions.json"} <= set(os.listdir(panel))
    cli.main(["--mode", "CShowImages", "--checkpoints_json", "ckpts.json",
              "--transform", "fog", "--severity", "4"] + common)
    with open("ab/imgs/predictions.json") as fh:  # out_dir has no ABtesting
        assert json.load(fh)["corruption"] == "fog"
    cli.main(["--mode", "ABShowAllImages"] + common)
    cli.main(["--mode", "CShowAllImages"] + common)
    pngs = os.listdir("ab/images/Tiny")
    assert len(pngs) == 12 + len(pab.CORRUPTION_LIST)
    assert pixels(f"ab/images/Tiny/{pab.CORRUPTION_LIST[0]}.png").shape == (
        36, 5 * 34 + 2, 3)


def test_cli_needs_cuda_unless_told_the_cpu(cli_setup, monkeypatch):
    common = [a for a in cli_setup if a not in ("--device", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--mode", "ABShowAllImages"] + common)
