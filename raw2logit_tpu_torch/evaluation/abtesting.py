"""Drift-synthesis evaluation harness (port of
``raw2logit_tpu/evaluation/abtesting.py``): the A/B pipeline-swap matrix
and the Hendrycks-C corruption tables.

A/B test: a model trained on static pipeline X is evaluated on data
processed by static pipeline Y, over the 12 x 12 cross product of
(debayer in {bilinear, malvar2004, menon2007}) x (sharpening in
{sharpening_filter, unsharp_masking}) x (denoising in {gaussian_denoising,
median_denoising}). C test: the model trained on X, evaluated on X + one
of 11 corruptions at severity 1..5.

A cell program (test pipeline, corruption, normalisation, classifier, or
without the pipeline on RGB that the pipeline computed once over the
dataset) runs on the device under ``torch.no_grad()``; nothing in a batch
waits for the card, and a cell reads its predictions back once, at its
end. The tables keep the JAX package's file format (cell keys, metric
keys, ``_meta``), so either package's ``*_show_table`` reads the other's.
"""

import hashlib
import itertools
import json
import os

import numpy as np
import torch

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.data import (Loader, PrecomputedRGBView, Subset,
                                      dataset_stats, get_dataset,
                                      precompute_pipeline_rgb)
from raw2logit_tpu_torch.evaluation.corruptions import distort
from raw2logit_tpu_torch.evaluation.metrics import (ConfusionMetrics,
                                                    over_n_runs)
from raw2logit_tpu_torch.isp import StaticPipeline
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet_model

DEBAYERS = ["bilinear", "malvar2004", "menon2007"]
SHARPENINGS = ["sharpening_filter", "unsharp_masking"]
DENOISINGS = ["gaussian_denoising", "median_denoising"]

CORRUPTION_LIST = ["identity", "gaussian_noise", "shot_noise",
                   "impulse_noise", "speckle_noise", "gaussian_blur",
                   "zoom_blur", "contrast", "brightness", "saturate",
                   "elastic_transform"]


def pipeline_grid():
    """The 12 static pipelines of the sweep."""
    return list(itertools.product(DEBAYERS, SHARPENINGS, DENOISINGS))


def pipeline_name(db, sh, dn):
    return f"{db}_{sh}_{dn}"


def _bounded_put(cache, key, value, size):
    """Put into a FIFO cache of ``size`` entries (the oldest leave)."""
    while len(cache) >= size:
        cache.pop(next(iter(cache)))
    cache[key] = value


class ABTesting:
    """Evaluate trained checkpoints across processing pipelines.

    Args:
        dataset_name: a ``get_dataset`` name: a folder dataset (Microscopy,
            DroneSegmentation, ...) or a synthetic one.
        batch_size: images per batch of a cell program and of the
            precompute.
        data_root: where a folder dataset lives (the synthetic ones take
            none). The JAX package takes it and reads ``data`` whatever
            it says; the port reads it.
        severity: the corruption severity where a call gives none.
        image_size: the mosaics' side (kept for the JAX package's
            signature; torch modules take any size).
        precompute_rgb: run each test pipeline once over the dataset and
            the cell programs on its RGB (same math as in graph).
        device: None means cuda, and raises when CUDA is missing.
        dataset_kwargs: passed to ``get_dataset`` (n, h, w, seed).
    """

    def __init__(self, dataset_name, batch_size=32, data_root="data",
                 severity=1, image_size=256, precompute_rgb=True,
                 device=None, **dataset_kwargs):
        self.dataset_name = dataset_name
        self.image_size = image_size
        self.device = resolve_device(device)
        if not dataset_name.startswith("Synthetic"):
            dataset_kwargs["data_root"] = data_root
        self.dataset = get_dataset(dataset_name, **dataset_kwargs)
        self.task = self.dataset.task
        self.batch_size = batch_size
        self.severity = severity
        self.precompute_rgb = precompute_rgb
        stats = dataset_stats(dataset_name)
        self.mean, self.std = (
            torch.tensor(stats[k], dtype=torch.float32,
                         device=self.device).reshape(3, 1, 1)
            for k in ("mean", "std"))
        self._model_cache, self._run_cache, self._rgb_cache = {}, {}, {}

    # -- model loading ----------------------------------------------------

    def load_model(self, checkpoint_path, network="resnet18",
                   smp_encoder="resnet34"):
        """The classifier of a ``save_module`` file (a run's
        ``checkpoints/classifier.pt``), in eval mode on the device;
        memoised per (path, network, encoder): a C table evaluates one
        checkpoint for 55 cells."""
        key = (str(checkpoint_path), network, smp_encoder)
        if key not in self._model_cache:
            # a ResNet is built on the meta device (no random init) and
            # takes the file's tensors as its own
            meta = self.task == "classification"
            model = self._build_classifier(
                network, smp_encoder,
                device=torch.device("meta") if meta else self.device)
            try:
                model.load_state_dict(torch.load(
                    os.path.abspath(checkpoint_path),
                    map_location=self.device, weights_only=True),
                    assign=meta)
            except RuntimeError as e:
                why = (f"--network {network} must name the run's classifier"
                       if self.task == "classification" else
                       f"the tables build every segmentation model on "
                       f"{smp_encoder}, as the JAX package's evaluate_runs "
                       f"does, whose restore fails on this checkpoint too "
                       f"(ROADMAP Queue 3)")
                raise ValueError(f"{checkpoint_path} does not load into the "
                                 f"model built for it: {why}") from e
            self._model_cache[key] = model.eval()
        return self._model_cache[key]

    def _build_classifier(self, network="resnet18", smp_encoder="resnet34",
                          device=None):
        device = self.device if device is None else device
        if self.task == "classification":
            return resnet_model(network, fc_out_features=len(
                self.dataset.classes), device=device)
        return UNetPlusPlus(encoder_name=smp_encoder, encoder_depth=5,
                            decoder_channels=(256, 128, 64, 32, 16),
                            classes=1, device=device)

    def _pipeline(self, db, sh, dn):
        return StaticPipeline(
            camera_parameters=self.dataset.camera_parameters,
            debayer=db, sharpening=sh, denoising=dn)

    # -- evaluation core ---------------------------------------------------

    def _eval_fn(self, test_pipeline=None, corruption="identity",
                 severity=None):
        """The cell program: ``run(classifier, x, generator)`` -> logits,
        the test pipeline on mosaics ``x`` (or, with no pipeline, ``x`` is
        its precomputed RGB: the same ops after it, in the same order) ->
        corruption (draws from ``generator``) -> normalisation ->
        classifier, on the device under no_grad."""
        severity = self.severity if severity is None else severity

        def run(classifier, x, generator):
            with torch.no_grad():
                rgb = x if test_pipeline is None else test_pipeline(x)
                rgb = distort(rgb, corruption, severity, generator)
                return classifier((rgb - self.mean) / self.std)

        return run

    def _run_for(self, network, debayer, sharpening, denoising,
                 corruption="identity", severity=None,
                 smp_encoder="resnet34"):
        """The in-graph cell program of one (test pipeline, corruption,
        severity), memoised (FIFO of 64)."""
        severity = self.severity if severity is None else severity
        key = (network, smp_encoder, debayer, sharpening, denoising,
               corruption, severity)
        if key not in self._run_cache:
            _bounded_put(self._run_cache, key, self._eval_fn(
                self._pipeline(debayer, sharpening, denoising), corruption,
                severity), 64)
        return self._run_cache[key]

    def _run_for_rgb(self, network, corruption="identity", severity=None,
                     smp_encoder="resnet34"):
        """The cell program on precomputed RGB, memoised in the same FIFO
        and shared by every pipeline."""
        severity = self.severity if severity is None else severity
        key = (network, smp_encoder, None, None, None, corruption, severity)
        if key not in self._run_cache:
            _bounded_put(self._run_cache, key,
                         self._eval_fn(None, corruption, severity), 64)
        return self._run_cache[key]

    def _pipeline_rgb(self, db, sh, dn):
        """The pipeline's RGB of the whole dataset (host float32), computed
        once; the 2 latest are kept (the tables visit pipelines in turn)."""
        name = pipeline_name(db, sh, dn)
        if name not in self._rgb_cache:
            _bounded_put(self._rgb_cache, name, precompute_pipeline_rgb(
                self.dataset, self._pipeline(db, sh, dn), self.batch_size,
                device=self.device), 2)
        return self._rgb_cache[name]

    def evaluate(self, classifier, valid_indices, debayer, sharpening,
                 denoising, corruption="identity", seed=0, severity=None):
        """One cell of the A/B (or C) matrix -> metrics dict, in graph."""
        run = self._eval_fn(self._pipeline(debayer, sharpening, denoising),
                            corruption, severity)
        return self._evaluate_with(run, classifier, valid_indices, seed=seed)

    def _evaluate_with(self, run, classifier, valid_indices, seed=0,
                       rgb_all=None):
        """``run`` over the valid images in batches, each batch's draws
        from one device generator seeded by ``seed``; classification
        metrics from the confusion matrix, segmentation the whole set's
        IoU (intersection and union summed over batches, so the last batch
        weighs by its pixels).

        The last batch stays ragged: JAX pads it to the batch size to keep
        one compiled program; on the card a padded batch read no faster end
        to end (PERF.md)."""
        base = (PrecomputedRGBView(self.dataset, rgb_all)
                if rgb_all is not None else self.dataset)
        loader = Loader(Subset(base, valid_indices), self.batch_size,
                        shuffle=False, drop_last=False)
        generator = torch.Generator(self.device).manual_seed(seed)
        batches = ((run(classifier, torch.as_tensor(x, device=self.device),
                        generator), y) for x, y in loader)
        if self.task == "classification":
            preds, labels = [], []
            for logits, y in batches:
                preds.append(logits.argmax(dim=-1))
                labels.append(y)
            cm = ConfusionMetrics(len(self.dataset.classes))
            cm.update(torch.cat(preds).cpu().numpy(), np.concatenate(labels))
            return cm.summary()
        inter = union = 0
        for logits, y in batches:
            pred = torch.sigmoid(logits)[:, 0] > 0.5
            mask = torch.as_tensor(y, device=self.device) > 0.5
            inter = inter + (pred & mask).sum()
            union = union + (pred | mask).sum()
        inter, union = int(inter), int(union)
        return {"iou": inter / union if union else 1.0}

    # -- fold aggregation ---------------------------------------------------

    @staticmethod
    def _fold_runs(ckpts, valid_indices, n_runs=None):
        """Normalise (checkpoints, valid_indices) into per-fold pairs.

        ckpts: a single path or a list of per-fold paths.
        valid_indices: one shared index list, or one list per fold.
        """
        if isinstance(ckpts, (str, os.PathLike)):
            ckpts = [ckpts]
        ckpts = list(ckpts)[: n_runs or None]
        per_fold_idx = (valid_indices
                        if valid_indices and isinstance(valid_indices[0],
                                                        (list, tuple))
                        else [valid_indices] * len(ckpts))
        if len(per_fold_idx) < len(ckpts):
            raise ValueError(f"{len(ckpts)} fold checkpoints but only "
                             f"{len(per_fold_idx)} valid_indices lists")
        return list(zip(ckpts, per_fold_idx))

    def evaluate_runs(self, ckpts, valid_indices, db, sh, dn,
                      corruption="identity", severity=None,
                      network="resnet18", n_runs=None):
        """One table cell aggregated over fold runs: mean and sample std
        per metric (``over_n_runs``). One cell program serves every fold;
        with ``precompute_rgb`` it reads the pipeline's memoised RGB."""
        rgb_all = None
        if self.precompute_rgb:
            rgb_all = self._pipeline_rgb(db, sh, dn)
            run = self._run_for_rgb(network, corruption=corruption,
                                    severity=severity)
        else:
            run = self._run_for(network, db, sh, dn, corruption=corruption,
                                severity=severity)
        return over_n_runs([
            self._evaluate_with(run, self.load_model(ckpt_path, network),
                                idx, rgb_all=rgb_all)
            for ckpt_path, idx in self._fold_runs(ckpts, valid_indices,
                                                  n_runs)])

    # -- tables -------------------------------------------------------------

    def ab_make_table(self, checkpoints, valid_indices, out_path,
                      network="resnet18", test_grid=None, n_runs=None):
        """The pipeline-swap matrix: rows = train pipeline, columns = test
        pipeline, each cell over the per-fold checkpoints.

        checkpoints: {train_pipeline_name: ckpt_path | [per-fold paths]}
        valid_indices: shared index list or one list per fold.
        test_grid: optional subset of pipeline triples for the columns.
        n_runs: evaluate at most this many folds per cell (--N_runs).

        Column-major (test pipeline outer): each column's precomputed RGB
        is made once and read by every row before the next column. Each
        cell is written through to ``out_path``; a cell already there is
        skipped, and a file whose ``_meta`` differs is discarded.
        """
        meta = self._table_meta(checkpoints, valid_indices, network, n_runs)
        table = self._load_partial(out_path, meta)
        grid = pipeline_grid()
        cols = test_grid if test_grid is not None else grid
        for (db_e, sh_e, dn_e) in cols:
            ename = pipeline_name(db_e, sh_e, dn_e)
            for (db_t, sh_t, dn_t) in grid:
                tname = pipeline_name(db_t, sh_t, dn_t)
                if tname not in checkpoints:
                    continue
                cell = f"{tname}__VS__{ename}"
                if cell in table:
                    continue
                mets = self.evaluate_runs(checkpoints[tname], valid_indices,
                                          db_e, sh_e, dn_e, network=network,
                                          n_runs=n_runs)
                table[cell] = mets
                print(f"{tname} vs {ename}: {mets}", flush=True)
                self._dump_partial(table, out_path)
        self._dump_partial(table, out_path)
        return table

    @staticmethod
    def _table_meta(checkpoints, valid_indices, network, n_runs,
                    **extra):
        """The configuration's fingerprint, stored under '_meta': a resumed
        table whose configuration changed is recomputed, never mixed."""
        def _h(obj):
            return hashlib.sha1(
                json.dumps(obj, sort_keys=True, default=str)
                .encode()).hexdigest()[:16]

        return {"n_runs": n_runs, "network": network,
                "checkpoints_hash": _h(checkpoints),
                "valid_indices_hash": _h(valid_indices), **extra}

    @staticmethod
    def _load_partial(out_path, meta=None):
        """The completed cells of an interrupted table (a file that does
        not parse counts as none); a table whose '_meta' differs from
        ``meta`` is discarded."""
        table = {}
        if out_path and os.path.exists(out_path):
            with open(out_path) as fh:
                try:
                    table = json.load(fh)
                except ValueError:
                    table = {}
        if meta is not None:
            if table and table.get("_meta") != meta:
                print(f"discarding {out_path}: config fingerprint changed "
                      f"({table.get('_meta')} -> {meta})", flush=True)
                table = {}
            table["_meta"] = meta
        return table

    @staticmethod
    def _dump_partial(table, out_path):
        """Write the table through an atomic rename."""
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        tmp = out_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(table, fh, indent=2)
        os.replace(tmp, out_path)

    def c_make_table(self, checkpoints, valid_indices, out_path,
                     network="resnet18", severities=(1, 2, 3, 4, 5),
                     n_runs=None):
        """Pipelines x corruptions x severities, fold-aggregated, written
        through and resumed as ``ab_make_table``."""
        meta = self._table_meta(checkpoints, valid_indices, network, n_runs,
                                severities=list(severities))
        table = self._load_partial(out_path, meta)
        for (db, sh, dn) in pipeline_grid():
            name = pipeline_name(db, sh, dn)
            if name not in checkpoints:
                continue
            for corr in CORRUPTION_LIST:
                for sev in severities:
                    cell = f"{name}__{corr}__s{sev}"
                    if cell in table:
                        continue
                    mets = self.evaluate_runs(
                        checkpoints[name], valid_indices, db, sh, dn,
                        corruption=corr, severity=sev, network=network,
                        n_runs=n_runs)
                    table[cell] = mets
                    print(f"{name} x {corr} s{sev}: {mets}", flush=True)
                    self._dump_partial(table, out_path)
        self._dump_partial(table, out_path)
        return table

    # -- model-involved image panels ----------------------------------------

    def _panel_input(self, ckpts, valid_indices, network, index):
        (ckpt_path, idx), *_ = self._fold_runs(ckpts, valid_indices)
        raw = torch.as_tensor(self.dataset[idx[index]][0],
                              device=self.device)[None]
        return self.load_model(ckpt_path, network), raw, idx[index]

    def _predict(self, classifier, rgb):
        """The prediction on ``rgb`` (1, 3, H, W): the class, or for
        segmentation the sigmoid mask (H, W) as numpy."""
        with torch.no_grad():
            logits = classifier((rgb - self.mean) / self.std)
        if self.task == "classification":
            return int(logits[0].argmax())
        return torch.sigmoid(logits)[0, 0].cpu().numpy()

    def ab_show_images(self, ckpts, valid_indices, train_pip, test_pip,
                       out_dir, network="resnet18", index=0):
        """Per trained model: the train- and test-pipeline images, their
        per-channel |diff| and log|diff| crops, and the model's prediction
        under each pipeline (the predicted masks for segmentation; the
        prediction flip for classification)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        classifier, raw, item = self._panel_input(ckpts, valid_indices,
                                                  network, index)
        imgs, preds = {}, {}
        for which, (db, sh, dn) in (("train", train_pip), ("test", test_pip)):
            with torch.no_grad():
                rgb = self._pipeline(db, sh, dn)(raw)
            imgs[which] = rgb[0].permute(1, 2, 0).cpu().numpy()
            fig = plt.figure()
            plt.imshow(np.clip(imgs[which], 0, 1))
            plt.title(f"{which.capitalize()} Image")
            fig.savefig(os.path.join(out_dir, f"img_{which}.png"))
            plt.close(fig)

            pred = self._predict(classifier, rgb)
            if self.task == "classification":
                preds[which] = pred
            else:
                preds[which] = float(pred.mean())
                fig = plt.figure()
                plt.imshow(pred)
                plt.title(f"Predicted mask ({which} pipeline)")
                fig.savefig(os.path.join(out_dir, f"mask_{which}.png"))
                plt.close(fig)

        diff = np.abs(imgs["train"] - imgs["test"])
        h, w = diff.shape[:2]
        sl = (slice(min(50, h // 4), min(200, h)),
              slice(min(50, w // 4), min(200, w)))
        for c, color in enumerate(["Red", "Green", "Blue"]):
            fig = plt.figure()
            plt.imshow(diff[sl[0], sl[1], c], cmap=f"{color}s")
            plt.title(f"|Train Image - Test Image| - {color}")
            plt.colorbar()
            fig.savefig(os.path.join(out_dir, f"diff_{color}.png"))
            plt.close(fig)
            fig = plt.figure()
            plt.imshow(np.log(np.where(diff[..., c] == 0.0, 1e-5,
                                       diff[..., c])))
            plt.title(f"log(|Train Image - Test Image|) - {color}")
            plt.colorbar()
            fig.savefig(os.path.join(out_dir, f"logdiff_{color}.png"))
            plt.close(fig)

        summary = {"train_pipeline": list(train_pip),
                   "test_pipeline": list(test_pip),
                   "prediction_train": preds["train"],
                   "prediction_test": preds["test"],
                   "prediction_flipped": preds["train"] != preds["test"]
                   if self.task == "classification" else None}
        if self.task == "classification":
            summary["label"] = int(self.dataset[item][1])
        with open(os.path.join(out_dir, "predictions.json"), "w") as fh:
            json.dump(summary, fh, indent=2)
        return summary

    def c_show_images(self, ckpts, valid_indices, test_pip, corruption,
                      severity, out_dir, network="resnet18", index=0):
        """The corrupted test-pipeline image and the model's prediction on
        it (draws from generators seeded 0)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        classifier, raw, _ = self._panel_input(ckpts, valid_indices, network,
                                               index)
        db, sh, dn = test_pip
        with torch.no_grad():
            rgb = distort(self._pipeline(db, sh, dn)(raw), corruption,
                          severity,
                          torch.Generator(self.device).manual_seed(0),
                          np.random.default_rng(0))
        fig = plt.figure()
        plt.imshow(np.clip(rgb[0].permute(1, 2, 0).cpu().numpy(), 0, 1))
        plt.title(f"{corruption} severity {severity}")
        fig.savefig(os.path.join(
            out_dir, f"{pipeline_name(db, sh, dn)}_{corruption}"
            f"_s{severity}.png"))
        plt.close(fig)

        pred = self._predict(classifier, rgb)
        if self.task != "classification":
            fig = plt.figure()
            plt.imshow(pred)
            fig.savefig(os.path.join(out_dir, "mask_corrupted.png"))
            plt.close(fig)
            pred = float(pred.mean())
        summary = {"corruption": corruption, "severity": severity,
                   "prediction": pred}
        with open(os.path.join(out_dir, "predictions.json"), "w") as fh:
            json.dump(summary, fh, indent=2)
        return summary


def _cell_value(v, metric):
    """A cell's ``<metric>_mean``, else ``metric``, else its first mean,
    else its first value."""
    key = (f"{metric}_mean" if f"{metric}_mean" in v else metric
           if metric in v else next((x for x in v if x.endswith("_mean")),
                                    list(v)[0]))
    return key, v[key]


def ab_show_table(table_path, metric="accuracy", out_png=None):
    """Render the A/B matrix as a heatmap of the fold mean, each cell
    annotated with the fold sigma where the table has one."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(table_path) as fh:
        table = json.load(fh)
    # rows and columns are different sets in general (a partial sweep);
    # '_meta' is the fingerprint, not a cell
    rows = sorted({k.split("__VS__")[0] for k in table if "__VS__" in k})
    cols = sorted({k.split("__VS__")[1] for k in table if "__VS__" in k})
    mat = np.full((len(rows), len(cols)), np.nan)
    sig = np.full((len(rows), len(cols)), np.nan)
    for k, v in table.items():
        if "__VS__" not in k:
            continue
        a, b = k.split("__VS__")
        mkey, mat[rows.index(a), cols.index(b)] = _cell_value(v, metric)
        skey = mkey.replace("_mean", "_std")
        if skey != mkey and skey in v:
            sig[rows.index(a), cols.index(b)] = v[skey]
    fig, ax = plt.subplots(figsize=(11, 10))
    im = ax.imshow(mat, cmap="viridis")
    if np.isfinite(sig).any():
        for i in range(len(rows)):
            for j in range(len(cols)):
                if np.isfinite(mat[i, j]):
                    ax.text(j, i, f"{mat[i, j]:.2f}\n±{sig[i, j]:.2f}",
                            ha="center", va="center", fontsize=4,
                            color="white")
    ax.set_xticks(range(len(cols)), cols, rotation=90, fontsize=6)
    ax.set_yticks(range(len(rows)), rows, fontsize=6)
    ax.set_xlabel("test pipeline")
    ax.set_ylabel("train pipeline")
    fig.colorbar(im)
    fig.tight_layout()
    out_png = out_png or table_path.replace(".json", ".png")
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png


def c_show_table(table_path, metric="accuracy", out_png=None):
    """Render the corruption table: rows = pipelines, columns =
    corruptions, each cell the mean over severities."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(table_path) as fh:
        table = json.load(fh)
    pipelines = sorted({k.split("__")[0] for k in table
                        if "__" in k and not k.startswith("_")})
    corruptions = [c for c in CORRUPTION_LIST
                   if any(f"__{c}__" in k for k in table)]
    mat = np.full((len(pipelines), len(corruptions)), np.nan)
    for i, p in enumerate(pipelines):
        for j, c in enumerate(corruptions):
            vals = [_cell_value(v, metric)[1] for k, v in table.items()
                    if k.startswith(f"{p}__{c}__")]
            if vals:
                mat[i, j] = float(np.mean(vals))
    fig, ax = plt.subplots(figsize=(12, 8))
    im = ax.imshow(mat, cmap="viridis")
    ax.set_xticks(range(len(corruptions)), corruptions, rotation=90,
                  fontsize=7)
    ax.set_yticks(range(len(pipelines)), pipelines, fontsize=7)
    ax.set_xlabel("corruption (mean over severities)")
    ax.set_ylabel("train pipeline")
    fig.colorbar(im)
    fig.tight_layout()
    out_png = out_png or table_path.replace(".json", ".png")
    fig.savefig(out_png, dpi=150)
    plt.close(fig)
    return out_png
