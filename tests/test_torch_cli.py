"""PyTorch port vs the JAX package: the training CLI's host modules
(k-fold splits, the loader, the augmentations, the run store) and a tiny
drift-forensics run through ``raw2logit_tpu_torch.training.train`` on the
CPU.

The k-fold split is held to the JAX package's (scikit-learn's
StratifiedShuffleSplit) index for index; the augmentations to the JAX
transforms with the same draws injected (JAX draws them from its keys,
the test hands them to the port).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu import augment as jaug
from raw2logit_tpu.data import Loader as JaxLoader
from raw2logit_tpu.data import k_fold as jax_k_fold

from raw2logit_tpu_torch import augment
from raw2logit_tpu_torch.data import (ArrayDataset, Loader, Subset,
                                      SyntheticRawClassification, k_fold)
from raw2logit_tpu_torch.tracking import Run
from raw2logit_tpu_torch.training import train as cli


class Labelled:
    """A dataset stand-in: only the task and labels matter to k_fold."""

    def __init__(self, labels, task="classification"):
        self.labels, self.task = list(labels), task

    def __len__(self):
        return len(self.labels)


@pytest.mark.parametrize("n,classes,n_splits,train_size,seed", [
    (10, 2, 1, 0.8, 1), (37, 3, 3, 0.7, 0), (64, 2, 2, 0.8, 5),
    (101, 5, 4, 0.55, 42), (12, 4, 2, 0.5, 7), (9, 2, 1, 0.8, 3)])
def test_k_fold_matches_sklearn(n, classes, n_splits, train_size, seed):
    """Stratified shuffle splits index for index as the JAX package's
    (scikit-learn), with uneven and tied class counts."""
    labels = np.random.default_rng(seed).integers(0, classes, n)
    labels[:2 * classes] = np.repeat(np.arange(classes), 2)
    ds = Labelled(labels)
    got = k_fold(ds, n_splits=n_splits, seed=seed, train_size=train_size)
    want = jax_k_fold(ds, n_splits=n_splits, seed=seed,
                      train_size=train_size)
    assert got == want


def test_k_fold_segmentation_matches_jax():
    ds = Labelled(range(23), task="segmentation")
    assert (k_fold(ds, n_splits=3, seed=4, train_size=0.8)
            == jax_k_fold(ds, n_splits=3, seed=4, train_size=0.8))


def test_k_fold_refuses_a_single_member_class():
    with pytest.raises(ValueError, match="only 1 member"):
        k_fold(Labelled([0, 0, 0, 1]), 1, 0, 0.5)


@pytest.mark.parametrize("shuffle,drop_last,prefetch", [
    (True, None, True), (False, False, True), (True, False, False)])
def test_loader_order_matches_jax(shuffle, drop_last, prefetch):
    """Two epochs of batches, the same items in the same order as the JAX
    loader's (shuffle by default_rng((seed, epoch)))."""
    rng = np.random.default_rng(0)
    ds = ArrayDataset(rng.uniform(size=(11, 4, 4)).astype(np.float32),
                      np.arange(11))
    sub = Subset(ds, [10, 3, 5, 7, 1, 0, 2, 9, 8])
    kw = dict(shuffle=shuffle, drop_last=drop_last, seed=3,
              prefetch=prefetch)
    ours, theirs = Loader(sub, 4, **kw), JaxLoader(sub, 4, **kw)
    assert len(ours) == len(theirs)
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert len(got) == len(want)
        for (x, y), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(x, np.asarray(wx))
            np.testing.assert_array_equal(y, np.asarray(wy))


def test_loader_stops_its_worker_early():
    ds = ArrayDataset(np.zeros((40, 2, 2), np.float32), np.arange(40))
    for x, _ in Loader(ds, 4):
        break
    assert x.shape == (4, 2, 2)


# --- augmentation ---------------------------------------------------------

def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def nhwc(a):
    return np.transpose(np.asarray(a), (0, 2, 3, 1))


def images(shape=(2, 3, 12, 17), seed=0):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("k", range(4))
def test_rot90_turns_as_jax(k):
    x = images((2, 3, 16, 16))  # the JAX rot90 needs square images
    got = augment.rot90(torch.from_numpy(x), k)
    want = jaug._rot90(jnp.asarray(nhwc(x)), k)
    np.testing.assert_array_equal(got.numpy(), nchw(want))
    mask = x[:, 0]
    np.testing.assert_array_equal(
        augment.rot90(torch.from_numpy(mask), k).numpy(),
        np.asarray(jaug._rot90(jnp.asarray(mask), k)))


@pytest.mark.parametrize("angle", [-90.0, -37.3, 0.0, 12.5, 45.0, 89.9])
def test_rotate_matches_jax(angle):
    """Nearest neighbour with zero fill, images and masks."""
    x = images((2, 3, 15, 20), seed=1)
    got = augment.rotate(torch.from_numpy(x), angle)
    want = jaug._rotate(jnp.asarray(nhwc(x)), jnp.float32(angle))
    np.testing.assert_array_equal(got.numpy(), nchw(want))
    mask = (x[:, 0] > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        augment.rotate(torch.from_numpy(mask), angle).numpy(),
        np.asarray(jaug._rotate(jnp.asarray(mask), jnp.float32(angle))))


def test_flips_noise_and_sharpness_match_jax():
    x = images()
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(augment.hflip(t).numpy(),
                                  nchw(jaug._hflip(nhwc(x))))
    np.testing.assert_array_equal(augment.vflip(t).numpy(),
                                  nchw(jaug._vflip(nhwc(x))))
    key = jax.random.key(3)
    noise = jax.random.normal(key, nhwc(x).shape, jnp.float32)
    np.testing.assert_allclose(
        augment.add_gaussian_noise(t, torch.tensor(nchw(noise))).numpy(),
        nchw(jaug._add_gaussian_noise(key, jnp.asarray(nhwc(x)))), rtol=0,
        atol=1e-7)
    np.testing.assert_allclose(augment.adjust_sharpness(t).numpy(),
                               nchw(jaug._adjust_sharpness(nhwc(x))), rtol=0,
                               atol=1e-6)


def jax_draws(kind, key, x_nhwc):
    """The draws the JAX augmentation takes from ``key``, in the port's
    form."""
    if kind == "weak":
        k1, k2, k3 = jax.random.split(key, 3)
        return {"hflip": bool(jax.random.bernoulli(k1)),
                "vflip": bool(jax.random.bernoulli(k2)),
                "k": int(jax.random.randint(k3, (), 0, 4))}
    k1, k2, k3, k4, k5, k6, k7 = jax.random.split(key, 7)
    noise = jax.random.normal(k6, x_nhwc.shape, x_nhwc.dtype)
    return {"hflip": bool(jax.random.bernoulli(k1)),
            "vflip": bool(jax.random.bernoulli(k2)),
            "rotate": bool(jax.random.bernoulli(k3)),
            "angle": float(jax.random.uniform(k4, (), minval=-90.0,
                                              maxval=90.0)),
            "noise": bool(jax.random.bernoulli(k5)),
            "noise_plane": torch.tensor(nchw(noise)),
            "sharpen": bool(jax.random.bernoulli(k7))}


@pytest.mark.parametrize("kind", ["weak", "strong"])
def test_augmentations_match_jax_with_injected_draws(kind):
    """Eight keys, so that every branch is taken; images and masks (the
    geometric transforms replayed, the photometric ones skipped)."""
    x = images((2, 3, 16, 16), seed=2)
    mask = (x[:, 0] > 0.5).astype(np.float32)
    aug = augment.get_augmentation(kind)
    jfn = jaug.get_augmentation(kind)
    seen = set()
    for i in range(8):
        key = jax.random.key(i)
        draws = jax_draws(kind, key, nhwc(x))
        seen.update(k for k, v in draws.items() if v is True)
        got = aug.apply(draws, torch.from_numpy(x))
        want = nchw(jfn(key, jnp.asarray(nhwc(x))))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        got = aug.apply(draws, torch.from_numpy(mask), is_mask=True)
        want = jfn(key, jnp.asarray(mask), is_mask=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert {"hflip", "vflip"} <= seen


@pytest.mark.parametrize("kind", ["weak", "strong"])
def test_augmentation_draws_are_seeded(kind):
    """The same generator seed gives the same draws and images."""
    x = torch.from_numpy(images((2, 3, 8, 8)))
    aug = augment.get_augmentation(kind)
    outs = [aug.apply(aug.draw(torch.Generator().manual_seed(4), x), x)
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1])


# --- run store ------------------------------------------------------------

def test_run_store(tmp_path):
    parent = Run("exp one", "run/1", root=str(tmp_path))
    assert parent.dir == os.path.join(str(tmp_path), "exp_one", "run_1")
    run = parent.child("run_1_0")
    assert run.dir == os.path.join(parent.dir, "run_1_0")
    run.log_params({"a": np.int64(1)})
    run.log_params({"b": [np.float32(0.5)]})
    with open(os.path.join(run.dir, "params.json")) as fh:
        assert json.load(fh) == {"a": 1, "b": [0.5]}
    run.log_metrics({"train_loss": 0.25}, step=0)
    run.log_metrics({"val_loss_aux": np.float64(-0.9)}, step=0)
    got = run.read_metrics()
    assert [m["step"] for m in got] == [0, 0]
    assert got[0]["train_loss"] == 0.25 and got[1]["val_loss_aux"] == -0.9
    run.log_state_dict({"train_indices": np.arange(3)})
    with open(os.path.join(run.dir, "state_dict.json")) as fh:
        assert json.load(fh) == {"train_indices": [0, 1, 2]}
    assert os.path.isdir(run.artifact_dir("checkpoints", "x"))
    run.close()
    # an unreachable tracking server leaves the run local, it does not raise
    local = Run("e", "r", root=str(tmp_path), tracking_uri="http://localhost:1")
    assert local._mlflow is None
    local.close()


# --- the CLI --------------------------------------------------------------

@pytest.fixture
def tiny_dataset(monkeypatch):
    """SyntheticRawClassification(n=8, h=64, w=64) in place of every
    dataset name (as tests/test_examples.py:26-32 does)."""
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw:
                        SyntheticRawClassification(n=8, h=64, w=64, seed=5))


def test_cli_forensics_run(tmp_path, monkeypatch, tiny_dataset):
    """Pretraining with a frozen processor and weak augmentation, then an
    SSIM-regularised attack on gamma with the noise layer, through the
    classifier file the pretraining wrote: the attack logs val_loss_aux,
    only gamma moves, and the classifier stays as loaded."""
    monkeypatch.chdir(tmp_path)
    common = ["--dataset", "SyntheticMicroscopy", "--batch_size", "4",
              "--n_splits", "1", "--device", "cpu", "--use_pallas",
              "--experiment_name", "forensics"]
    (pre,) = cli.main(common + ["--freeze_processor", "--augmentation",
                                "weak", "--epochs", "1", "--lr", "1e-3",
                                "--run_name", "pretrain",
                                "--checkpoint_every_n_epochs", "1"])
    clf_path = os.path.join(pre["run"].dir, "checkpoints", "classifier.pt")
    assert os.path.exists(clf_path)
    assert os.path.exists(os.path.join(pre["run"].dir, "checkpoints",
                                       "epoch_0001.pt"))
    assert any("val_accuracy" in m for m in pre["run"].read_metrics())

    (adv,) = cli.main(common + [
        "--adv_training", "--freeze_classifier", "--classifier_uri",
        clf_path, "--adv_aux_loss", "ssim", "--adv_aux_weight", "-1",
        "--adv_noise_layer", "--adv_parameters", "gamma_correct",
        "--epochs", "2", "--lr", "1e-2", "--run_name", "adv_gamma"])
    metrics = adv["run"].read_metrics()
    aux = [m["val_loss_aux"] for m in metrics if "val_loss_aux" in m]
    assert len(aux) == 2 and all(-1.0 <= a < 0 for a in aux)
    state = adv["state"]
    ref = dict(state.ref_processor.named_parameters())
    for name, p in state.processor.named_parameters():
        moved = not torch.equal(p, ref[name])
        assert moved == (name == "gamma_correct"), name
    want = torch.load(clf_path, weights_only=True)
    for name, t in state.classifier.state_dict().items():
        assert torch.equal(t, want[name]), name


def test_cli_resume_continues_from_the_last_checkpoint(tmp_path, monkeypatch,
                                                       tiny_dataset):
    monkeypatch.chdir(tmp_path)
    args = ["--dataset", "SyntheticMicroscopy", "--batch_size", "4",
            "--device", "cpu", "--lr", "1e-3", "--run_name", "r",
            "--checkpoint_every_n_epochs", "1"]
    cli.main(args + ["--epochs", "1"])
    (res,) = cli.main(args + ["--epochs", "2", "--resume"])
    assert res["state"].step == 2  # one batch of 4 from 6 per epoch
    steps = [m["step"] for m in res["run"].read_metrics()
             if "train_loss" in m]
    assert steps == [0, 1]


def test_cli_static_mode_with_and_without_precompute(tmp_path, monkeypatch,
                                                     tiny_dataset):
    """--processing_mode static, with the pipeline in every step and with
    --precompute_static, trains to the same classifier (the same split,
    augmentation draws and update math), as tests/test_training.py holds
    the JAX package's two paths; neither run trains or saves a
    processor, and the run records the pipeline's choices."""
    monkeypatch.chdir(tmp_path)

    def train(extra, name):
        (res,) = cli.main([
            "--dataset", "SyntheticMicroscopy", "--processing_mode",
            "static", "--sp_debayer", "malvar2004", "--sp_denoising",
            "median_denoising", "--epochs", "2", "--batch_size", "4",
            "--n_splits", "1", "--lr", "1e-3", "--augmentation", "weak",
            "--device", "cpu", "--experiment_name", "pc", "--run_name",
            name, *extra])
        return res

    in_graph = train([], "pc0")
    pre = train(["--precompute_static"], "pc1")
    flat = [torch.cat([p.detach().flatten() for p in
                       r["state"].classifier.parameters()]).numpy()
            for r in (in_graph, pre)]
    diff = np.abs(flat[1] - flat[0])
    # the tolerance of tests/test_training.py: Adam turns a rounding-level
    # gradient difference on a near-zero leaf into a +-lr update
    assert np.max(diff) < 5.0 * 1e-3, np.max(diff)
    assert np.mean(diff < 1e-4) > 0.999
    assert pre["state"].processor is None
    assert list(in_graph["state"].processor.parameters()) == []
    assert in_graph["state"].step == pre["state"].step == 2
    for r in (in_graph, pre):
        assert os.listdir(os.path.join(r["run"].dir, "checkpoints")) == [
            "classifier.pt"]
        with open(os.path.join(r["run"].dir, "state_dict.json")) as fh:
            sd = json.load(fh)
        assert (sd["sp_debayer"], sd["sp_sharpening"], sd["sp_denoising"]) \
            == ("malvar2004", "sharpening_filter", "median_denoising")
        assert any("val_accuracy" in m for m in r["run"].read_metrics())


def test_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch, tiny_dataset):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--dataset", "SyntheticMicroscopy"])
