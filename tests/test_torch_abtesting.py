"""PyTorch port vs the JAX package: the evaluation harness
(``evaluation/abtesting.py``, ``evaluation/metrics.py``).

All on the CPU, on 32x32 SyntheticMicroscopy (and SyntheticDrone)
mosaics. Both packages' harnesses evaluate the same classifiers: flax
variables of ResNet-18 (and of the CLI's resnet34 U-Net++) made with
numpy from a seed on the tree of ``jax.eval_shape`` (flax's init compiles
for about 25 s on one core), handed to JAX's ``ABTesting`` through its
model cache and to the port's as ``save_module`` files of the
``convert.resnet_state_dict`` weights. The JAX results are computed once
per module.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.evaluation import abtesting as jab
from raw2logit_tpu.evaluation import metrics as jmetrics
from raw2logit_tpu.models import UNetPlusPlus as JUNetPlusPlus
from raw2logit_tpu.models import resnet_model as jresnet_model

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.evaluation import abtesting as pab
from raw2logit_tpu_torch.evaluation import metrics
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet_model
from raw2logit_tpu_torch.training.checkpoint import save_module

SIZE = 32
DATA = dict(n=12, h=SIZE, w=SIZE)
PIPES = [("bilinear", "sharpening_filter", "gaussian_denoising"),
         ("malvar2004", "unsharp_masking", "median_denoising")]
VALID = [1, 3, 4, 6, 7, 9, 10]  # 7 images: batches of 4 and a ragged 3
# test_evaluation.py:382 holds JAX's two cell-program paths to 1e-4
LOGIT_ATOL = 1e-4
# the least |logit difference| for which a float32 rounding cannot flip a
# class
MARGIN = 1e-3


def random_variables(model, rng):
    """flax variables of ``model`` for SIZE x SIZE inputs, as numpy:
    kernels N(0, 1 / fan_in), BN scales U(0.5, 1.5), biases and running
    means N(0, 0.1), running variances U(0.5, 2)."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))

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
    return np.moveaxis(np.asarray(a), -1, -3)


class Pair:
    """The two packages' harnesses on one dataset, holding the same
    checkpoints: ``ckpts`` maps a pipeline name to its classifier file
    (the JAX harness reads the same variables from its model cache under
    that path)."""

    def __init__(self, root, dataset_name, task, pipes, seed, **data):
        self.j = jab.ABTesting(dataset_name, batch_size=4, image_size=SIZE,
                               **data)
        self.p = pab.ABTesting(dataset_name, batch_size=4, image_size=SIZE,
                               device="cpu", **data)
        self.root = str(root)
        rng = np.random.default_rng(seed)
        self.ckpts, self.variables, self.models = {}, {}, {}
        for i, pip in enumerate(pipes):
            if task == "classification":
                jmodel = jresnet_model("resnet18", fc_out_features=2)
                model = resnet_model("resnet18", device="cpu")
            else:
                jmodel = JUNetPlusPlus(encoder_name="resnet34",
                                       encoder_depth=5,
                                       decoder_channels=(256, 128, 64, 32,
                                                         16), classes=1)
                model = UNetPlusPlus(device="cpu")
            variables = random_variables(jmodel, rng)
            model.load_state_dict(convert.resnet_state_dict(variables))
            path = save_module(model, os.path.join(
                self.root, f"{task}_{i}", "classifier.pt"))
            name = pab.pipeline_name(*pip)
            self.ckpts[name] = [path]
            self.variables[name], self.models[name] = variables, model.eval()
            # JAX's load_model memoises here (made at its first call)
            vars(self.j).setdefault("_model_cache", {})[
                (path, "resnet18", "resnet34")] = (jmodel, variables)

    def logits(self, name, pip, corruption, severity, idx):
        """Both packages' logits of the precomputed-RGB cell program for
        the classifier ``name`` on the pipeline ``pip``'s images ``idx``
        (batches of 4, JAX's key and the port's generator seeded 0)."""
        jrun = self.j._run_for_rgb("resnet18", corruption, severity)
        prun = self.p._run_for_rgb("resnet18", corruption, severity)
        jrgb = self.j._pipeline_rgb(*pip)
        prgb = self.p._pipeline_rgb(*pip)
        gen = torch.Generator().manual_seed(0)
        jl, pl = [], []
        for s in range(0, len(idx), 4):
            b = idx[s:s + 4]
            jl.append(np.asarray(jrun(self.variables[name],
                                      jnp.asarray(jrgb[b]),
                                      jax.random.key(0))))
            pl.append(prun(self.models[name], torch.from_numpy(prgb[b]),
                           gen).numpy())
        return np.concatenate(jl), np.concatenate(pl)


@pytest.fixture(scope="module")
def clf(tmp_path_factory):
    return Pair(tmp_path_factory.mktemp("clf"), "SyntheticMicroscopy",
                "classification", PIPES, seed=5, **DATA)


@pytest.fixture(scope="module")
def ab_tables(clf, tmp_path_factory):
    """Both packages' A/B table over PIPES x PIPES (identity cells)."""
    root = tmp_path_factory.mktemp("tables")
    out = {}
    for which, ab in (("jax", clf.j), ("port", clf.p)):
        path = str(root / which / "ABtable.json")
        out[which] = (path, ab.ab_make_table(clf.ckpts, VALID, path,
                                             test_grid=PIPES))
    return out


def test_metrics_match_jax_exactly():
    rng = np.random.default_rng(0)
    summaries = {"jax": [], "port": []}
    for _ in range(3):
        preds, labels = rng.integers(0, 3, 40), rng.integers(0, 3, 40)
        for which, mod in (("jax", jmetrics), ("port", metrics)):
            cm = mod.ConfusionMetrics(3)
            cm.update(preds, labels)
            summaries[which].append(cm.summary())
    assert summaries["port"] == summaries["jax"]
    assert (metrics.over_n_runs(summaries["port"])
            == jmetrics.over_n_runs(summaries["jax"]))
    one = metrics.over_n_runs(summaries["port"][:1])
    assert one == jmetrics.over_n_runs(summaries["jax"][:1])
    assert one["accuracy_std"] == 0.0


def test_ab_table_matches_jax(clf, ab_tables):
    """Every identity cell's metrics equal JAX's, in a file of JAX's
    format (cell keys, metric keys, ``_meta``); the logits behind them
    within LOGIT_ATOL, and no prediction within MARGIN of a tie."""
    (_, jtable), (ppath, ptable) = ab_tables["jax"], ab_tables["port"]
    assert list(ptable) == list(jtable)
    assert len(ptable) == 1 + len(PIPES) ** 2
    for key in ptable:
        assert ptable[key] == jtable[key], key
    with open(ppath) as fh:
        assert json.load(fh) == jtable
    for name in clf.ckpts:
        for pip in PIPES:
            jl, pl = clf.logits(name, pip, "identity", 1, VALID)
            np.testing.assert_allclose(pl, jl, rtol=0, atol=LOGIT_ATOL)
            assert np.abs(jl[:, 0] - jl[:, 1]).min() > MARGIN


@pytest.mark.parametrize("pip", PIPES)
def test_contrast_cell_matches_jax(clf, pip):
    name = pab.pipeline_name(*PIPES[0])
    kw = dict(corruption="contrast", severity=2)
    assert (clf.p.evaluate_runs(clf.ckpts[name], VALID, *pip, **kw)
            == clf.j.evaluate_runs(clf.ckpts[name], VALID, *pip, **kw))
    jl, pl = clf.logits(name, pip, "contrast", 2, VALID)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=LOGIT_ATOL)
    assert np.abs(jl[:, 0] - jl[:, 1]).min() > MARGIN


def test_folds_aggregate_as_jax(clf):
    """Two fold checkpoints with per-fold valid indices: mean and sample
    std over the folds equal JAX's; --N_runs truncates."""
    folds = [p for paths in clf.ckpts.values() for p in paths]
    per_fold = [VALID[:4], [0, 2, 5, 8, 11]]
    for n_runs in (None, 1):
        got = clf.p.evaluate_runs(folds, per_fold, *PIPES[1],
                                  n_runs=n_runs)
        assert got == clf.j.evaluate_runs(folds, per_fold, *PIPES[1],
                                          n_runs=n_runs)
        assert got["n_runs"] == (n_runs or 2)


def test_segmentation_cell_matches_jax(tmp_path):
    """The CLI's resnet34 U-Net++ on SyntheticDrone: the whole set's IoU
    within 1e-6 of JAX's, with no pixel's logit nearer 0 than ten times
    the largest difference between the packages' logits (else a float32
    rounding could flip it)."""
    seg = Pair(tmp_path, "SyntheticDrone", "segmentation", PIPES[:1],
               seed=6, n=4, h=SIZE, w=SIZE)
    (name, (path,)), = seg.ckpts.items()
    idx = [0, 1, 2, 3]
    got = seg.p.evaluate_runs([path], idx, *PIPES[0])
    want = seg.j.evaluate_runs([path], idx, *PIPES[0])
    assert set(got) == set(want) == {"n_runs", "iou_mean", "iou_std"}
    assert abs(got["iou_mean"] - want["iou_mean"]) <= 1e-6
    jl, pl = seg.logits(name, PIPES[0], "identity", 1, idx)
    err = np.abs(nchw(jl) - pl).max()
    assert err <= LOGIT_ATOL and np.abs(jl).min() > 10 * err


def test_precomputed_path_matches_in_graph(clf):
    """The cell program on precomputed RGB against the one that runs the
    pipeline in graph: the same metrics and, on the same draws, logits
    within LOGIT_ATOL."""
    graph = pab.ABTesting("SyntheticMicroscopy", batch_size=4,
                          precompute_rgb=False, device="cpu", **DATA)
    name, pip = pab.pipeline_name(*PIPES[0]), PIPES[1]
    for corr in ("identity", "gaussian_noise", "contrast"):
        kw = dict(corruption=corr, severity=2)
        assert (clf.p.evaluate_runs(clf.ckpts[name], VALID, *pip, **kw)
                == graph.evaluate_runs(clf.ckpts[name], VALID, *pip, **kw))
    raw = torch.from_numpy(np.stack([graph.dataset[i][0] for i in VALID]))
    logits = []
    for run, x in ((graph._run_for("resnet18", *pip, "gaussian_noise", 2),
                    raw),
                   (clf.p._run_for_rgb("resnet18", "gaussian_noise", 2),
                    torch.from_numpy(clf.p._pipeline_rgb(*pip)[VALID]))):
        logits.append(run(clf.models[name], x,
                          torch.Generator().manual_seed(3)).numpy())
    np.testing.assert_allclose(logits[0], logits[1], rtol=0,
                               atol=LOGIT_ATOL)


def test_evaluate_is_one_cell_in_graph(clf):
    """``evaluate`` (a classifier as given, the pipeline in graph) gives
    the cell that ``evaluate_runs`` gives on its checkpoint."""
    name, kw = pab.pipeline_name(*PIPES[0]), dict(corruption="contrast",
                                                  severity=2)
    got = clf.p.evaluate(clf.models[name], VALID, *PIPES[1], **kw)
    want = clf.p.evaluate_runs(clf.ckpts[name], VALID, *PIPES[1], **kw)
    assert {f"{k}_mean": v for k, v in got.items()} == {
        k: v for k, v in want.items() if k.endswith("_mean")}


def test_tables_resume_and_discard_a_stale_meta(clf, tmp_path):
    """Write-through after every cell; a rerun computes no cell; a changed
    --N_runs or valid set discards the table; a file that does not parse
    resumes from nothing."""
    out = str(tmp_path / "tables" / "ab.json")
    ckpts = {k: v for k, v in list(clf.ckpts.items())[:1]}
    cell = f"{next(iter(ckpts))}__VS__{pab.pipeline_name(*PIPES[0])}"
    table = clf.p.ab_make_table(ckpts, VALID, out, test_grid=PIPES[:1])
    assert [k for k in table if k != "_meta"] == [cell]
    assert table["_meta"] == jab.ABTesting._table_meta(
        ckpts, VALID, "resnet18", None)
    table[cell] = {"accuracy_mean": -1.0}
    with open(out, "w") as fh:
        json.dump(table, fh)
    again = clf.p.ab_make_table(ckpts, VALID, out, test_grid=PIPES[:1])
    assert again[cell] == {"accuracy_mean": -1.0}
    fresh = clf.p.ab_make_table(ckpts, VALID, out, test_grid=PIPES[:1],
                                n_runs=1)
    assert fresh[cell] != {"accuracy_mean": -1.0}
    assert fresh["_meta"]["n_runs"] == 1
    other = clf.p.ab_make_table(ckpts, VALID[:5], out, test_grid=PIPES[:1],
                                n_runs=1)
    assert other["_meta"] != fresh["_meta"]
    with open(out, "w") as fh:
        fh.write("{ not json")
    assert cell in clf.p.ab_make_table(ckpts, VALID, out,
                                       test_grid=PIPES[:1])


def test_the_port_renders_jax_s_table(ab_tables, tmp_path):
    """The port's ab_show_table on the JAX package's file (JAX's renderers
    on the port's tables: tests/test_torch_eval_figures.py)."""
    out = str(tmp_path / "ab.png")
    assert pab.ab_show_table(ab_tables["jax"][0], out_png=out) == out
    assert os.path.getsize(out) > 0


def test_folder_dataset_and_missing_cuda_raise(tmp_path, monkeypatch):
    """A folder dataset whose folder is missing goes to its download,
    which raises where the mirror cannot be reached (stubbed here: the
    tests never reach the network); the folder datasets themselves:
    tests/test_torch_folder_data.py."""
    from raw2logit_tpu_torch.data import download

    def offline(data_root="data", force_download=False):
        raise FileNotFoundError(f"no mirror for {data_root}")
    monkeypatch.setattr(download, "download_microscopy_dataset", offline)
    with pytest.raises(FileNotFoundError, match="no mirror"):
        pab.ABTesting("Microscopy", data_root=str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pab.ABTesting("SyntheticMicroscopy", **DATA)


def test_a_segmentation_checkpoint_of_another_encoder_raises(tmp_path):
    """The harness restores every segmentation checkpoint into a resnet34
    U-Net++ (JAX's evaluate_runs passes no encoder): a resnet18 run's
    classifier raises a ValueError that says so."""
    ab = pab.ABTesting("SyntheticDrone", batch_size=2, device="cpu", n=2,
                       h=SIZE, w=SIZE)
    path = save_module(UNetPlusPlus(encoder_name="resnet18", device="cpu"),
                       str(tmp_path / "classifier.pt"))
    with pytest.raises(ValueError, match="resnet34"):
        ab.evaluate_runs(path, [0, 1], *PIPES[0])


def test_cell_programs_are_memoised_by_resolved_severity():
    ab = pab.ABTesting("SyntheticMicroscopy", severity=3, device="cpu",
                       **DATA)
    assert (ab._run_for("resnet18", *PIPES[0], corruption="contrast")
            is ab._run_for("resnet18", *PIPES[0], corruption="contrast",
                           severity=3))
    assert (ab._run_for_rgb("resnet18", corruption="contrast")
            is ab._run_for_rgb("resnet18", corruption="contrast",
                               severity=3))
