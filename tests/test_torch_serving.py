"""PyTorch port's serving path vs the JAX package: ``Predictor`` logits and
``predict_dir`` predictions on the same carried-across weights, the run
store's lookups, ``Predictor.from_run`` and the serving CLI on a
parametrized and a static run, the data layer, the device rule of the
entry points, and the port's independence from JAX.

All on the CPU, with a narrow ResNet (8 filters, one block per stage),
and ResNet-18 at full width where a run is served.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.data import datasets as jdatasets
from raw2logit_tpu.data import dng as jdng
from raw2logit_tpu.isp import ParametrizedProcessing as JaxProcessing
from raw2logit_tpu.isp import StaticPipeline as JaxStaticPipeline
from raw2logit_tpu.models import resnet as jresnet
from raw2logit_tpu.serving import Predictor as JaxPredictor

from raw2logit_tpu_torch import convert, serving
from raw2logit_tpu_torch.data import datasets, dng
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.kernels import fused_isp
from raw2logit_tpu_torch.models import resnet
from raw2logit_tpu_torch.serving import Predictor
from raw2logit_tpu_torch.tracking import (Run, display_run_info, find_run,
                                          get_model_by_name, list_runs)
from raw2logit_tpu_torch.training import checkpoint as ckpt

REPO = os.path.join(os.path.dirname(__file__), "..")
MICROSCOPY_CAM = datasets.MICROSCOPY_CAMERA_PARAMS
# f32 ISP + a few conv layers, two implementations (as test_torch_resnet)
LOGIT_ATOL = 1e-4


def perturb_bn(cv, rng):
    """Random BN means and scales (the zero-initialised ones included), so
    that eval-mode batch norms do not reduce to identities."""
    def perturb(path, a):
        if path[-1].key == "mean":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if path[-1].key == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(perturb, cv)


@pytest.fixture(scope="module")
def pair():
    """(JAX Predictor, port Predictor) on the same weights: the fused-ISP
    path (use_pallas / use_kernel) with non-trivial BN statistics, and a
    narrow ResNet with random BN parameters."""
    rng = np.random.default_rng(1)
    jproc = JaxProcessing(camera_parameters=MICROSCOPY_CAM, use_pallas=True)
    pv = jax.device_get(jproc.init(jax.random.key(0),
                                   jnp.zeros((1, 32, 32)), train=False))
    pv["batch_stats"]["batch_norm"] = {
        "mean": rng.uniform(0.2, 0.6, 3).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, 3).astype(np.float32)}
    jclf = jresnet.ResNet(block_cls=jresnet.BasicBlock,
                          stage_sizes=(1, 1, 1, 1), num_filters=8,
                          num_classes=2)
    cv = perturb_bn(jax.device_get(jclf.init(
        jax.random.key(1), jnp.zeros((1, 32, 32, 3)), train=False)), rng)
    jpred = JaxPredictor(jproc, jclf, pv, cv)

    proc = ParametrizedProcessing(use_kernel=True, device="cpu")
    proc.load_state_dict(convert.isp_state_dict(pv))
    clf = resnet.ResNet(stage_sizes=(1, 1, 1, 1), num_filters=8,
                        num_classes=2, device="cpu")
    clf.load_state_dict(convert.resnet_state_dict(cv))
    return jpred, Predictor(proc, clf, device="cpu")


def test_predictor_matches_jax(pair, raw_batch):
    jpred, pred = pair
    got = pred(raw_batch)
    assert got.shape == (4, 2) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(jpred(raw_batch)),
                               rtol=0, atol=LOGIT_ATOL)


def test_predict_dir_matches_jax(pair, tmp_path):
    jpred, pred = pair
    ds = datasets.SyntheticRawClassification(n=5, h=32, w=32, seed=3)
    for i in range(len(ds)):
        mosaic = np.round(ds[i][0] * 65535).astype(np.uint16)
        dng.write_dng(str(tmp_path / f"img_{i}.dng"), mosaic)
    (tmp_path / "notes.txt").write_text("not an image")
    records = []
    for p in (pred, jpred):
        out = p.predict_dir(str(tmp_path), batch_size=2,
                            out_path=str(tmp_path / f"{id(p)}.jsonl"))
        with open(out) as fh:
            records.append([json.loads(line) for line in fh])
    got, want = records
    assert [r["file"] for r in got] == [r["file"] for r in want]
    assert len(got) == 5
    assert [r["pred"] for r in got] == [r["pred"] for r in want]
    np.testing.assert_allclose([r["logits"] for r in got],
                               [r["logits"] for r in want], rtol=0,
                               atol=LOGIT_ATOL)


def test_dng_and_dataset_match_jax(tmp_path):
    """The port's copies of the DNG I/O and the synthetic dataset give the
    JAX package's arrays."""
    ds = datasets.SyntheticRawClassification(n=3, h=24, w=20, seed=5)
    jds = jdatasets.SyntheticRawClassification(n=3, h=24, w=20, seed=5)
    for i in range(3):
        np.testing.assert_array_equal(ds[i][0], jds[i][0])
        assert ds[i][1] == jds[i][1]
    mosaic = np.round(ds[0][0] * 65535).astype(np.uint16)
    path = str(tmp_path / "a.dng")
    dng.write_dng(path, mosaic, rows_per_strip=7, active_area=(2, 2, 22, 18))
    np.testing.assert_array_equal(dng.read_dng(path), jdng.read_dng(path))
    np.testing.assert_array_equal(datasets.load_image(path),
                                  jdatasets.load_image(path))
    assert datasets.list_images_in_dir(str(tmp_path)) == \
        jdatasets.list_images_in_dir(str(tmp_path))


def test_get_dataset_synthetic_names():
    assert datasets.get_dataset("SyntheticMicroscopy", n=2).task == \
        "classification"
    seg = datasets.get_dataset("SyntheticDrone", n=2, h=16, w=16)
    np.testing.assert_array_equal(
        seg[1][1], jdatasets.get_dataset("SyntheticDrone", n=2, h=16,
                                         w=16)[1][1])
    with pytest.raises(ValueError):  # the folder names: test_torch_folder_data
        datasets.get_dataset("NoSuchDataset")


@pytest.mark.parametrize("entry", ["processing", "resnet", "predictor"])
def test_entry_points_without_device_need_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid")
    make = {
        "processing": lambda: ParametrizedProcessing(),
        "resnet": lambda: resnet.resnet_model("resnet18"),
        "predictor": lambda: Predictor(
            ParametrizedProcessing(device="cpu"),
            resnet.ResNet(stage_sizes=(1,), num_filters=8, device="cpu")),
    }[entry]
    launches = fused_isp.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert fused_isp.launches == launches


def test_port_imports_no_jax():
    """Importing every module of the port (and chip_smoke.py) loads
    neither jax, flax nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import raw2logit_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = ('isp.static', 'ops.demosaic', 'ops.denoise_extra',\n"
        "       'data.precompute', 'tracking.run', 'serving',\n"
        "       'models.unetpp', 'isp.neural', 'isp.identity', 'app',\n"
        "       'training.sweep', 'tracking.images', 'parallel.mesh',\n"
        "       'parallel.distributed', 'parallel.spatial',\n"
        "       'parallel.pipelines', 'examples.drift_cycle',\n"
        "       'examples.drift_forensics', 'examples.drift_optimization')\n"
        "assert all(pkg.__name__ + '.' + m in sys.modules for m in new)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'orbax', 'raw2logit_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules\n"
        "                 if m.startswith('raw2logit_tpu_torch')]))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 15, r.stdout


def test_process_fn_and_segmentation_records(tmp_path):
    """``process_fn`` replaces the ISP module, and segmentation serves
    sigmoid masks summarised per file, as in the JAX Predictor."""
    clf = torch.nn.Conv2d(3, 1, 1)
    pred = Predictor(None, clf, task="segmentation", device="cpu",
                     process_fn=lambda raw: raw[:, None].expand(-1, 3, -1, -1))
    ds = datasets.SyntheticRawSegmentation(n=2, h=16, w=16, seed=2)
    raws = []
    for i in range(2):
        mosaic = np.round(ds[i][0] * 65535).astype(np.uint16)
        dng.write_dng(str(tmp_path / f"m{i}.dng"), mosaic)
        raws.append(mosaic / 65535.0)
    out = pred.predict_dir(str(tmp_path), batch_size=2,
                           out_path=str(tmp_path / "seg.jsonl"))
    with open(out) as fh:
        records = [json.loads(line) for line in fh]
    with torch.no_grad():
        x = torch.as_tensor(np.stack(raws), dtype=torch.float32)
        masks = torch.sigmoid(clf(x[:, None].expand(-1, 3, -1, -1))).numpy()
    for rec, m in zip(records, masks):
        assert rec["mask_mean"] == pytest.approx(float(m.mean()), abs=1e-6)
        assert rec["mask_pixels"] == int((m > 0.5).sum())


# --- runs: the run store's lookups, from_run and the serving CLI ----------

RUN_SIZE = 32
STATIC_SP = {"sp_debayer": "menon2007", "sp_sharpening": "unsharp_masking",
             "sp_denoising": "median_denoising"}


def write_port_run(root, experiment, name, state_dict, modules):
    """A port run as the training CLI records it: the parent, its fold-0
    child with the state dict and ``checkpoints/<name>.pt`` per module."""
    run = Run(experiment, name, root=root).child(f"{name}_0")
    run.log_state_dict(state_dict)
    for comp, module in modules.items():
        ckpt.save_module(module, os.path.join(run.dir, "checkpoints",
                                              f"{comp}.pt"))
    return run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two port runs on weights carried across from JAX: 'param' (the
    fused-ISP processor with BN statistics, and ResNet-18 with perturbed
    BNs) and 'static' (the same ResNet-18 behind the static ISP of
    ``STATIC_SP``); and the JAX Predictors that serve the same weights."""
    root = str(tmp_path_factory.mktemp("runs"))
    rng = np.random.default_rng(2)
    cam = datasets.MICROSCOPY_CAMERA_PARAMS
    jproc = JaxProcessing(camera_parameters=cam, use_pallas=True)
    pv = jax.device_get(jproc.init(
        jax.random.key(0), jnp.zeros((1, RUN_SIZE, RUN_SIZE)), train=False))
    pv["batch_stats"]["batch_norm"] = {
        "mean": rng.uniform(0.2, 0.6, 3).astype(np.float32),
        "var": rng.uniform(0.5, 1.5, 3).astype(np.float32)}
    jclf = jresnet.resnet_model("resnet18", fc_out_features=2)
    cv = perturb_bn(jax.device_get(jclf.init(
        jax.random.key(1), jnp.zeros((1, RUN_SIZE, RUN_SIZE, 3)),
        train=False)), rng)

    proc = ParametrizedProcessing(device="cpu")
    proc.load_state_dict(convert.isp_state_dict(pv))
    clf = resnet.resnet_model("resnet18", fc_out_features=2, device="cpu")
    clf.load_state_dict(convert.resnet_state_dict(cv))
    write_port_run(root, "e", "param", {"processing_mode": "parametrized"},
                   {"processor": proc, "classifier": clf})
    write_port_run(root, "e", "static",
                   {"processing_mode": "static", **STATIC_SP},
                   {"classifier": clf})

    stats = datasets.DATASET_STATS["Microscopy"]
    jpipe = JaxStaticPipeline(camera_parameters=cam,
                              debayer=STATIC_SP["sp_debayer"],
                              sharpening=STATIC_SP["sp_sharpening"],
                              denoising=STATIC_SP["sp_denoising"])
    mean = jnp.asarray(stats["mean"], jnp.float32)
    std = jnp.asarray(stats["std"], jnp.float32)
    return {"root": root,
            "param": JaxPredictor(jproc, jclf, pv, cv),
            "static": JaxPredictor(
                None, jclf, None, cv,
                process_fn=lambda raw: (jpipe(raw) - mean) / std)}


def from_run(runs, name, mode, **kw):
    return Predictor.from_run(
        "e", name, dataset_name="SyntheticMicroscopy", processing_mode=mode,
        image_size=RUN_SIZE, root=runs["root"], device="cpu", n=2, **kw)


def run_mosaics(seed, n=4):
    ds = datasets.SyntheticRawClassification(n=n, h=RUN_SIZE, w=RUN_SIZE,
                                             seed=seed)
    return np.stack([ds[i][0] for i in range(n)])


def test_get_model_by_name(runs, capsys):
    """A parent's name and a fold, or the child's name, find the port's
    checkpoint files; a static run has no processor file; an unknown
    run or experiment raises."""
    root = runs["root"]
    sd, ckpts = get_model_by_name("e", "param", root=root)
    assert sd == {"processing_mode": "parametrized"}
    child = os.path.join(root, "e", "param", "param_0", "checkpoints")
    assert ckpts == {"processor": os.path.join(child, "processor.pt"),
                     "classifier": os.path.join(child, "classifier.pt")}
    # the child by name: the parent run is its experiment
    assert get_model_by_name("param", "param_0", root=os.path.join(
        root, "e")) == (sd, ckpts)
    sd, ckpts = get_model_by_name("e", "static", root=root)
    assert sd["sp_debayer"] == "menon2007"
    assert ckpts["processor"] is None and ckpts["classifier"].endswith(
        os.path.join("static_0", "checkpoints", "classifier.pt"))
    assert list_runs("e", root=root) == ["param", "static"]
    with pytest.raises(FileNotFoundError, match="run not found"):
        get_model_by_name("e", "nope", root=root)
    with pytest.raises(FileNotFoundError, match="experiment not found"):
        list_runs("nope", root=root)
    display_run_info(find_run("e", "static", root=root))
    assert "artifacts at" in capsys.readouterr().out


def test_from_run_parametrized_matches_jax(runs):
    """The run's processor (fused ISP, BN statistics) and ResNet-18 served
    from their files give the JAX Predictor's logits on the same
    weights."""
    pred = from_run(runs, "param", "parametrized")
    assert pred.processor.use_kernel and pred.classes == [
        "dark_blob", "bright_blob"]
    assert pred.state_dict == {"processing_mode": "parametrized"}
    raw = run_mosaics(seed=3)
    np.testing.assert_allclose(pred(raw).numpy(),
                               np.asarray(runs["param"](raw)), rtol=0,
                               atol=LOGIT_ATOL)


def test_from_run_static_matches_jax(runs):
    """A static run: the pipeline rebuilt from the run's sp_* arguments,
    then the normalisation and ResNet-18, against a JAX Predictor whose
    process_fn is JAX's static pipeline and the same normalisation."""
    pred = from_run(runs, "static", "static")
    assert pred.processor is None
    raw = run_mosaics(seed=4)
    np.testing.assert_allclose(pred(raw).numpy(),
                               np.asarray(runs["static"](raw)), rtol=0,
                               atol=LOGIT_ATOL)


def test_from_run_refusals(runs):
    with pytest.raises(FileNotFoundError, match="no processor checkpoint"):
        from_run(runs, "static", "parametrized")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Predictor.from_run("e", "static", root=runs["root"])


def test_serving_main_on_a_dng_folder(runs, tmp_path, monkeypatch):
    """``serving.main`` serves the static run on a folder of DNGs: one
    record per image, logits as the JAX Predictor's ``predict_dir``."""
    monkeypatch.chdir(tmp_path)
    img_dir = tmp_path / "dngs"
    img_dir.mkdir()
    for i, mosaic in enumerate(run_mosaics(seed=5, n=5)):
        dng.write_dng(str(img_dir / f"img_{i}.dng"),
                      np.round(mosaic * 65535).astype(np.uint16))
    (img_dir / "readme.txt").write_text("not an image")
    argv = ["--experiment_name", "e", "--run_name", "static", "--image_dir",
            str(img_dir), "--dataset", "SyntheticMicroscopy",
            "--processing_mode", "static", "--batch_size", "2",
            "--out", "pred.jsonl"]
    monkeypatch.setattr(serving.Predictor, "from_run", functools.partial(
        serving.Predictor.from_run.__func__, serving.Predictor,
        root=runs["root"], image_size=RUN_SIZE))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving.main(argv)
    out = serving.main(argv + ["--device", "cpu"])
    with open(out) as fh:
        got = [json.loads(line) for line in fh]
    want_path = runs["static"].predict_dir(str(img_dir), batch_size=2,
                                           out_path="jax.jsonl")
    with open(want_path) as fh:
        want = [json.loads(line) for line in fh]
    assert len(got) == 5
    assert [r["file"] for r in got] == [r["file"] for r in want]
    assert {r["class"] for r in got} <= {"dark_blob", "bright_blob"}
    np.testing.assert_allclose([r["logits"] for r in got],
                               [r["logits"] for r in want], rtol=0,
                               atol=LOGIT_ATOL)
