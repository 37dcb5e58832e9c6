"""The port's experiment drivers (``raw2logit_tpu_torch.examples``): the
constrained-best selection and the drift report against the JAX example
module's on the same numbers, and the three drivers end to end on the
CPU at n = 8, 64x64, with the assertions tests/test_examples.py holds
the JAX drivers to; their reports carry the committed JAX artifacts'
keys, and they write under results/torch/ by default, never over a
committed file.
"""

import importlib.util
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from raw2logit_tpu_torch.data import (MICROSCOPY_CAMERA_PARAMS,
                                      SyntheticRawClassification)
from raw2logit_tpu_torch.evaluation import abtesting
from raw2logit_tpu_torch.examples import (drift_cycle, drift_forensics,
                                          drift_optimization)
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.training import train as cli

REPO = os.path.join(os.path.dirname(__file__), "..")


def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def committed(name):
    with open(os.path.join(REPO, "results", name)) as fh:
        return json.load(fh)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A temporary directory, and n = 8 64x64 SyntheticMicroscopy for the
    CLI and the A/B evaluator."""
    monkeypatch.chdir(tmp_path)
    small = (lambda name, **kw:
             SyntheticRawClassification(n=8, h=64, w=64, seed=5))
    monkeypatch.setattr(cli, "get_dataset", small)
    monkeypatch.setattr(abtesting, "get_dataset", small)
    return tmp_path


SELECTIONS = [
    (1.0, [0.5, 0.3, 0.2], [0.9, 0.6, 0.3], 0.5),
    (1.0, [0.4, 0.4, 0.4], [0.7, 0.9, 0.8], 0.5),
    (1.0, [0.4, 0.4], [0.3, 0.1], 0.5),
    (1.0, [1.0, 1.0], [0.99, 0.97], 0.5),
    (1.0, [0.2], [0.5], 0.5),
    (0.9, [0.9, 0.1, 0.1, 0.5], [1.0, 0.7, 0.8, 0.4], 0.6),
]


@pytest.mark.parametrize("case", SELECTIONS)
def test_select_epoch_is_jax_s(case):
    want = jax_example("drift_forensics").select_epoch(*case)
    assert drift_forensics.select_epoch(*case) == want


def test_drift_is_jax_s():
    """The relative drift of every ISP parameter, from the port's modules,
    equals JAX's from the same numbers under its names."""
    rng = np.random.default_rng(4)
    ref = ParametrizedProcessing(MICROSCOPY_CAMERA_PARAMS, image_size=8,
                                 additive_layer=True, device="cpu")
    adv = ParametrizedProcessing(MICROSCOPY_CAMERA_PARAMS, image_size=8,
                                 additive_layer=True, device="cpu")
    with torch.no_grad():
        for name, p in adv.named_parameters():
            if "gamma" in name or "debayer" in name or "additive" in name:
                p.add_(torch.from_numpy(rng.normal(
                    0, 0.05, p.shape).astype(np.float32)))
    state = types.SimpleNamespace(processor=adv, ref_processor=ref)
    got = drift_forensics._drift(state)
    flat = drift_forensics._flat_params
    jstate = types.SimpleNamespace(proc_params=flat(adv),
                                   ref_proc_params=flat(ref))
    want = jax_example("drift_forensics")._drift(jstate)
    assert got == want
    assert list(got) == list(committed("forensics_all.json")[
        "param_drift_relmax"])
    assert got["gamma_correct"] > 0 and got["black_level"] == 0.0


def test_defaults_write_under_results_torch():
    for fn in (drift_forensics.run_forensics,
               drift_optimization.run_optimization):
        assert inspect.signature(fn).parameters[
            "out_dir"].default == "results/torch"
    assert drift_cycle.TABLE_PATH.startswith("results/torch/")


def test_drift_forensics_runs(tiny):
    (report,) = drift_forensics.run_forensics(
        targets=("gamma_correct",), pre_epochs=1, adv_epochs=2,
        batch_size=4, out_dir="out", extra=["--device", "cpu"])
    assert set(report) == set(committed("forensics_gamma_correct.json"))
    assert report["target"] == "gamma_correct"
    assert 0.0 <= report["final_val_accuracy"] <= 1.0
    assert len(report["aux_ssim_per_epoch"]) == 2
    if report["selected_epoch"] is not None:
        assert report["selected_aux_ssim"] >= report["ssim_bound"]
        assert set(report["selected_param_drift_relmax"]) == set(
            report["param_drift_relmax"])
    # the targeted attack moves gamma (and the injected layer) only
    drift = report["param_drift_relmax"]
    assert drift["gamma_correct"] > 0.0
    for name, rel in drift.items():
        if "gamma" not in name and "additive" not in name:
            assert rel == 0.0, (name, rel)
    assert report["selection_replay_match"] in (None, True)
    # stage tracking is on by default: JAX's artifacts under the run
    arts = report["stage_artifacts"]
    assert {"img_diffs_6_noise.png", "img_gradients_5_gamma_correct.png",
            "img_processing_0_demosaic.png"} <= set(os.listdir(arts))
    with open(tiny / "out" / "forensics_gamma_correct.json") as fh:
        assert json.load(fh) == report
    assert not os.path.exists(tiny / "results" / "forensics_gamma_correct.json")


def test_drift_optimization_runs(tiny):
    report = drift_optimization.run_optimization(
        epochs=1, batch_size=4, out_dir="out", extra=["--device", "cpu"])
    assert set(report) == set(committed("drift_optimization.json"))
    assert len(report["frozen_val_loss"]) == 1
    assert len(report["joint_val_loss"]) == 1
    assert os.path.exists(tiny / "out" / "drift_optimization.json")
    assert drift_optimization._epochs_to([0.5, 0.99, 1.0]) == 2
    assert drift_optimization._epochs_to([0.5]) is None


def test_drift_cycle_runs(tiny):
    summary = drift_cycle.run_cycle(
        train_pipelines=[("bilinear", "sharpening_filter",
                          "gaussian_denoising")],
        epochs=1, batch_size=4, table_path=str(tiny / "tables" / "ab.json"),
        device="cpu")
    assert 0.0 <= summary["matched_acc"] <= 1.0
    assert summary["swapped_acc"] is None
    assert os.path.exists(summary["table_path"])
    assert os.path.exists(summary["heatmap"])
    with open(summary["table_path"]) as fh:
        table = json.load(fh)
    assert "_meta" in table and any("__VS__" in k for k in table)
