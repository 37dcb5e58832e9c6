"""The port's stage tracking (``tracking/images.py``: ``stage_gradients``,
``track_images``, ``log_tensor``) against the JAX package's, on one
JAX-initialised ISP (stages tracked, output BN, additive layer) and
ResNet-18 carried across by ``convert.py``, at 4x32x32; and the CLI's
``--track_*`` files, by name against what JAX's ``track_images`` writes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu import losses as jlosses
from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.models import resnet_model as jax_resnet
from raw2logit_tpu.tracking import images as jimages

from raw2logit_tpu_torch import convert, losses
from raw2logit_tpu_torch.data import (MICROSCOPY_CAMERA_PARAMS,
                                      SyntheticRawClassification)
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.models import resnet_model
from raw2logit_tpu_torch.tracking import images
from raw2logit_tpu_torch.training import train as cli
from test_torch_resnet import randomize

B, SIZE, NCLS = 4, 32, 3
# the stages are the ISP's plain float32 ops in both packages (the fused
# ISP's tolerance); the stage gradients go back through ResNet-18's
# eval-mode convolutions in two frameworks, held relative to the stage's
# largest gradient at the float32 gradient tier of
# tests/test_reference_parity.py (tests/test_torch_train.py's GRAD_TOL;
# measured up to 2.0e-4 here); the logits at the classifier's 1e-4
STAGE_TOL, GRAD_TOL, LOGIT_TOL = 2e-5, 2e-3, 1e-4


def loss_pair():
    return (jlosses.weighted_loss(jlosses.cross_entropy_loss, -1.0),
            losses.weighted_loss(losses.cross_entropy_loss, -1.0))


@pytest.fixture(scope="module")
def models():
    """(JAX ISP, its variables, a perturbed reference's variables, JAX
    ResNet-18, its variables, the port's ISP, reference ISP and ResNet-18
    with the same weights), and a batch."""
    rng = np.random.default_rng(7)
    raw = rng.uniform(0.05, 0.9, (B, SIZE, SIZE)).astype(np.float32)
    labels = rng.integers(0, NCLS, B).astype(np.int32)
    jproc = JaxProcessing(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                          track_stages=True, batch_norm_output=True,
                          additive_layer=True, image_size=SIZE)
    v = jax.device_get(jproc.init(jax.random.key(0), jnp.asarray(raw),
                                  train=False))
    params = {k: np.asarray(a) for k, a in v["params"].items()}
    params["additive_layer"] = rng.normal(
        0, 0.01, params["additive_layer"].shape).astype(np.float32)
    stats = {"batch_norm": {"mean": np.full(3, 0.4, np.float32),
                            "var": np.full(3, 0.8, np.float32)}}
    pv = {"params": params, "batch_stats": stats}
    ref_params = dict(params, gamma_correct=params["gamma_correct"] * 1.1,
                      additive_layer=np.zeros_like(params["additive_layer"]))
    rv = {"params": ref_params, "batch_stats": stats}
    jclf = jax_resnet("resnet18", fc_out_features=NCLS)
    cv = randomize(jclf.init(jax.random.key(1),
                             jnp.zeros((1, SIZE, SIZE, 3)), train=False), rng)

    def port_isp(variables):
        m = ParametrizedProcessing(MICROSCOPY_CAMERA_PARAMS,
                                   track_stages=True, additive_layer=True,
                                   image_size=SIZE, device="cpu")
        m.load_state_dict(convert.isp_state_dict(variables))
        return m

    clf = resnet_model("resnet18", fc_out_features=NCLS, device="cpu")
    clf.load_state_dict(convert.resnet_state_dict(cv))
    return dict(raw=raw, labels=labels, jproc=jproc, pv=pv, rv=rv,
                jclf=jclf, cv=cv, proc=port_isp(pv), ref=port_isp(rv),
                clf=clf)


def nhwc(x):
    x = np.asarray(x)
    return np.moveaxis(x, 1, -1) if x.ndim == 4 else x


def rel(got, want):
    return float(np.abs(got - want).max()) / max(
        float(np.abs(want).max()), 1e-30)


def test_stage_gradients_match_jax(models):
    m = models
    jloss, ploss = loss_pair()
    jst, jgr = jimages.stage_gradients(m["jproc"], m["pv"], m["jclf"],
                                       m["cv"], jloss, jnp.asarray(m["raw"]),
                                       jnp.asarray(m["labels"]))
    pst, pgr = images.stage_gradients(
        m["proc"], m["clf"], ploss, torch.from_numpy(m["raw"]),
        torch.from_numpy(m["labels"]).long())
    assert set(pst) == set(jst) == set(pgr) == set(jgr)
    assert "noise" in pst and "sharpening" in pst
    for name in jst:
        assert rel(nhwc(pst[name]), np.asarray(jst[name])) < STAGE_TOL, name
        assert rel(nhwc(pgr[name]), np.asarray(jgr[name])) < GRAD_TOL, name
    # the modules get their modes back
    assert m["proc"].training and m["clf"].training


@pytest.fixture(scope="module")
def tracked(models, tmp_path_factory):
    """Both packages' track_images of the batch in two loader batches,
    with the differences from the reference and the predictions."""
    m = models
    jloss, ploss = loss_pair()
    root = tmp_path_factory.mktemp("tracked")
    batches = [(m["raw"][:3], m["labels"][:3]), (m["raw"][3:], m["labels"][3:])]
    jimages.track_images(m["jproc"], m["pv"], m["jclf"], m["cv"], jloss,
                         batches, reference_variables=m["rv"],
                         save_loc=str(root / "jax"))
    images.track_images(m["proc"], m["clf"], ploss,
                        [(r, y.astype(np.int64)) for r, y in batches],
                        reference=m["ref"], save_loc=str(root / "port"))
    return root


def test_track_images_writes_jax_s_files(tracked):
    jax_files = sorted(os.listdir(tracked / "jax"))
    assert sorted(os.listdir(tracked / "port")) == jax_files
    assert "diffs_6_noise.npy" not in jax_files  # diffs: PNG grids only
    assert {"processing_6_noise.npy", "img_diffs_6_noise.png",
            "gradients_0_demosaic.npy", "preds.npy"} <= set(jax_files)


def test_track_images_values_match_jax(tracked):
    for f in sorted(os.listdir(tracked / "jax")):
        if not f.endswith(".npy"):
            continue
        want = np.load(tracked / "jax" / f)
        got = nhwc(np.load(tracked / "port" / f))
        tol = {"processing": STAGE_TOL, "gradients": GRAD_TOL,
               "preds": LOGIT_TOL}.get(f.split("_")[0].split(".")[0], 0.0)
        assert got.shape == want.shape, f
        assert rel(got, want) <= tol, (f, rel(got, want))


def test_log_tensor_names_and_grid(tmp_path):
    x = np.random.default_rng(0).uniform(size=(3, 3, 8, 8))
    images.log_tensor(torch.from_numpy(x), str(tmp_path / "a_1.npy"))
    images.log_tensor(x, str(tmp_path / "b.npy"), save_tensors=False)
    assert sorted(os.listdir(tmp_path)) == ["a_1.npy", "img_a_1.png",
                                            "img_b.png"]
    np.testing.assert_array_equal(np.load(tmp_path / "a_1.npy"), x)


@pytest.mark.parametrize("every_epoch", [False, True])
def test_cli_tracks_with_jax_s_file_names(tracked, tmp_path, monkeypatch,
                                          every_epoch):
    """--track_* through the CLI (with --use_pallas, which tracking runs
    through the plain ISP, as the JAX package does): the files are
    JAX's track_images's, under the run's results/ (per epoch with
    --track_every_epoch)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw:
                        SyntheticRawClassification(n=8, h=SIZE, w=SIZE,
                                                   seed=2))
    argv = ["--dataset", "SyntheticMicroscopy", "--epochs", "2",
            "--batch_size", "4", "--test_run", "--device", "cpu",
            "--adv_training", "--freeze_classifier", "--adv_noise_layer",
            "--adv_track_differences", "--track_processing",
            "--track_processing_gradients", "--track_predictions",
            "--track_save_tensors", "--track_n_images", "5", "--use_pallas",
            "--experiment_name", "t", "--run_name", "r"]
    if every_epoch:
        argv.append("--track_every_epoch")
    (res,) = cli.main(argv)
    assert not res["state"].processor.use_kernel or \
        res["state"].processor.track_stages
    base = os.path.join(res["run"].dir, "results")
    dirs = ([os.path.join(base, f"epoch_{e:04d}") for e in (1, 2)]
            if every_epoch else [base])
    for d in dirs:
        assert sorted(os.listdir(d)) == sorted(os.listdir(tracked / "jax"))
        assert np.load(os.path.join(d, "preds.npy")).shape == (5, 2)
