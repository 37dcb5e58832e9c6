"""The training CLI (port of ``raw2logit_tpu/training/train.py``):

    python -m raw2logit_tpu_torch.training.train \
        --dataset SyntheticMicroscopy --use_pallas --epochs 2 \
        --batch_size 32 [--device cpu]

dataset -> k-fold -> per fold: processor and task model -> (adversarial
setup) -> train and validation epochs -> checkpoints, recorded in the
local run store under ``results/runs/<experiment>/<run>/<run>_<fold>/``.
The parser keeps the JAX package's whole flag surface and adds
``--device`` (``cuda`` unless given; raises without CUDA). It runs every
processing mode: the parametrized ISP (plain, frozen or adversarial),
the static ISP (``--processing_mode static``: the pipeline and the
normalisation in every step, or once over the dataset with
``--precompute_static``), the neural ISP (``neural_network``) and the
identity packing (``none``); a classification dataset trains a ResNet, a
segmentation dataset (``SyntheticDrone``) a U-Net++. ``--track_*``
writes the tracked stages, their gradients, the adversarial differences
and the predictions under the run's ``results/`` (``tracking.images``).
``--compute_dtype bfloat16`` computes the task model in bfloat16 (every
ISP stays float32; checkpoints stay float32). ImageNet weights converted
to ``weights/<model>.npz`` (the JAX package's npz layout) are overlaid as
in the JAX CLI: onto the classifier with ``--classifier_pretrained``
(required, conv1 and fc kept at their init), onto a U-Net++ encoder and
the neural ISP's encoder whenever the file exists. ``--profile`` writes a
``torch.profiler`` trace of global steps [1, 4) of each fold into the
run's ``profile/`` directory.

Data parallelism is one process per device: N processes started with
``COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=<rank>`` join
a process group (``parallel.distributed.initialize``; NCCL on the card,
gloo with ``--device cpu``), rank r trains on rows [r B/N, (r + 1) B/N)
of every global batch of B, the steps compute the single-device step on
the global batch, and only rank 0 writes the run store, the checkpoints
and the tracked images. ``--n_devices`` defaults to the group's size.
``--dataset`` takes the folder datasets (Microscopy, the Drone sets,
under ``data/`` of the working directory, at exposure ``--I_ratio``) and
the synthetic ones; ``--tracking_uri`` (or ``MLFLOW_TRACKING_URI``)
mirrors the run to an MLflow server. ``--staged_step`` trains with the
staged step (``make_staged_train_step``), and ``--fuse_opt`` with it
steps one Adam per module inside its stages (a split state, whose
checkpoints resume only with ``--fuse_opt``).
"""

import argparse
import contextlib
import json
import os
import re
import sys
import time

import numpy as np
import torch

from raw2logit_tpu_torch import resolve_device, tracing
from raw2logit_tpu_torch.data import (Loader, PrecomputedRGBView, Subset,
                                      dataset_stats, get_dataset, k_fold,
                                      precompute_pipeline_rgb)
from raw2logit_tpu_torch.isp import (NNProcessing, ParametrizedProcessing,
                                     RawToRGB, StaticPipeline)
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet_model
from raw2logit_tpu_torch.models.resnet import load_pretrained_variables
from raw2logit_tpu_torch.parallel import distributed
from raw2logit_tpu_torch.tracking import Run, track_images
from raw2logit_tpu_torch.tracking.run import run_dir
from raw2logit_tpu_torch.training import checkpoint as ckpt
from raw2logit_tpu_torch.training.core import (TrainConfig, create_train_state,
                                               make_eval_step,
                                               make_staged_train_step,
                                               make_train_step,
                                               task_loss_fn)


def str2bool(s):
    return s == "True" or s is True


def build_parser():
    """The JAX package's CLI surface (the reference's train.py flags and
    its TPU extras), and ``--device``."""
    p = argparse.ArgumentParser(description="classification_task")
    p.add_argument("--tracking_uri", type=str, default=None,
                   help="MLflow server URI to mirror the run to (else "
                        "MLFLOW_TRACKING_URI); runs are always recorded "
                        "under results/runs")
    p.add_argument("--processor_uri", type=str, default=None,
                   help="processor state-dict file to load the processor "
                        "from (a run's checkpoints/processor.pt)")
    p.add_argument("--classifier_uri", type=str, default=None,
                   help="classifier state-dict file to load the classifier "
                        "from (a run's checkpoints/classifier.pt)")
    p.add_argument("--state_dict_uri", type=str, default=None,
                   help="path of a state_dict.json with train/valid indices")

    p.add_argument("--experiment_name", type=str,
                   default="classification learnable pipeline")
    p.add_argument("--run_name", type=str, default="test run")

    p.add_argument("--log_model", type=str2bool, default=True)
    p.add_argument("--save_locally", action="store_true",
                   help="additionally copy the final per-fold state to "
                        "saved_models/<experiment>/<run>_<fold>")

    p.add_argument("--track_processing", action="store_true")
    p.add_argument("--track_processing_gradients", action="store_true")
    p.add_argument("--track_save_tensors", action="store_true")
    p.add_argument("--track_predictions", action="store_true")
    p.add_argument("--track_n_images", type=int, default=5)
    p.add_argument("--track_every_epoch", action="store_true")

    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--dataset", type=str, default="Microscopy",
                   choices=["Drone", "DroneSegmentation", "Microscopy",
                            "SyntheticMicroscopy", "SyntheticDrone"])
    p.add_argument("--I_ratio", "--iso", dest="I_ratio", type=float,
                   default=1.0,
                   help="exposure-intensity variant of the dataset")
    p.add_argument("--n_splits", type=int, default=1)
    p.add_argument("--train_size", type=float, default=0.8)

    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--augmentation", type=str, default="none",
                   choices=["none", "weak", "strong"])
    p.add_argument("--check_val_every_n_epoch", type=int, default=1)

    p.add_argument("--processing_mode", type=str, default="parametrized",
                   choices=["parametrized", "static", "neural_network",
                            "none"])

    p.add_argument("--classifier_network", type=str, default="ResNet18",
                   choices=["ResNet18", "ResNet34", "Resnet50"])
    p.add_argument("--classifier_pretrained", action="store_true")
    p.add_argument("--smp_encoder", type=str, default="resnet34")

    p.add_argument("--freeze_processor", action="store_true")
    p.add_argument("--freeze_classifier", action="store_true")

    p.add_argument("--sp_debayer", type=str, default="bilinear",
                   choices=["bilinear", "malvar2004", "menon2007"])
    p.add_argument("--sp_sharpening", type=str, default="sharpening_filter",
                   choices=["sharpening_filter", "unsharp_masking"])
    p.add_argument("--sp_denoising", type=str, default="gaussian_denoising",
                   choices=["gaussian_denoising", "median_denoising",
                            "fft_denoising"])

    p.add_argument("--adv_training", action="store_true")
    p.add_argument("--adv_aux_weight", type=float, default=1.0)
    p.add_argument("--adv_aux_loss", type=str, default="ssim",
                   choices=["l2", "ssim"])
    p.add_argument("--adv_noise_layer", action="store_true")
    p.add_argument("--adv_track_differences", action="store_true")
    p.add_argument("--adv_parameters", default="all",
                   choices=["all", "black_level", "white_balance",
                            "colour_correction", "gamma_correct",
                            "sharpening_filter", "gaussian_blur",
                            "additive_layer"])

    p.add_argument("--cache_downloaded_models", type=str2bool, default=True,
                   help="accepted for CLI parity; the local run store never "
                        "downloads")
    p.add_argument("--test_run", action="store_true")

    p.add_argument("--n_devices", type=int, default=None,
                   help="devices of the data-parallel group, one process "
                        "each (default: the group's size, 1 without one)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="task-model compute dtype (ISP always float32)")
    p.add_argument("--use_pallas", action="store_true",
                   help="the fused ISP kernels (parametrized mode; stage "
                        "tracking runs the plain ISP, as in the JAX "
                        "package): ParametrizedProcessing(use_kernel=True)")
    p.add_argument("--precompute_static", action="store_true",
                   help="static mode only: run the static pipeline and the "
                        "normalisation over the dataset once and train the "
                        "classifier on the cached RGB (the same math: "
                        "augmentation applies after processing either way)")
    p.add_argument("--weight_decay", type=float, default=0.0,
                   help="coupled L2 weight decay (torch.optim.Adam "
                        "semantics)")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"],
                   help="cosine decays to 0 over the fold's total steps")
    p.add_argument("--profile", action="store_true",
                   help="trace train steps [1, 4) of each fold into the "
                        "run's profile/ directory (torch.profiler)")
    p.add_argument("--staged_step", action="store_true",
                   help="the staged train step: the same update in explicit "
                        "stages (ISP forward, classifier gradient, aux "
                        "gradient, ISP backward, Adam), each calling the "
                        "kernels directly")
    p.add_argument("--fuse_opt", action="store_true",
                   help="with --staged_step: one Adam per module, each "
                        "stepped inside the stage that computes its "
                        "gradients (the same update); checkpoints resume "
                        "only with the same flag")
    p.add_argument("--checkpoint_every_n_epochs", type=int, default=0,
                   help="periodic checkpointing for failure recovery "
                        "(0 = only final)")
    p.add_argument("--resume", action="store_true",
                   help="resume each fold from its latest periodic "
                        "checkpoint if present")
    p.add_argument("--device", type=str, default="cuda",
                   help="where to train: cuda (the default; raises without "
                        "CUDA) or cpu")
    return p


def _static_pipeline(args, dataset):
    return StaticPipeline(camera_parameters=dataset.camera_parameters,
                          debayer=args.sp_debayer,
                          sharpening=args.sp_sharpening,
                          denoising=args.sp_denoising)


class _StaticAsModule(torch.nn.Module):
    """The static pipeline under ``no_grad``, then (rgb - mean) / std: the
    processor of static mode. It has no parameters and no state dict
    entries (mean and std are buffers that are not saved)."""

    def __init__(self, pipeline, mean, std, device):
        super().__init__()
        self.pipeline = pipeline
        for name, v in (("mean", mean), ("std", std)):
            self.register_buffer(name, torch.tensor(
                v, dtype=torch.float32, device=device).reshape(3, 1, 1),
                persistent=False)

    def forward(self, raw):
        with torch.no_grad():
            rgb = self.pipeline(raw)
        return (rgb - self.mean) / self.std, {}


# Processing modes whose RGB is (H/2, W/2): a segmentation mask is (H, W)
HALF_RESOLUTION_MODES = ("neural_network", "none")


def _refuse_unrunnable(args, task):
    """Raise where the JAX package cannot run the combination either."""
    if task == "segmentation" and args.processing_mode in \
            HALF_RESOLUTION_MODES:
        raise ValueError(
            f"--processing_mode {args.processing_mode} gives (H/2, W/2) "
            f"RGB and the masks of a segmentation dataset are (H, W): the "
            f"JAX package fails on this combination too (its Dice loss "
            f"cannot broadcast them, ROADMAP Queue 3)")


def build_processor(args, dataset, image_size, device, generator):
    """The processing mode's module (the neural ISP's U-Net++ draws its
    init from ``generator``)."""
    stats = dataset_stats(args.dataset)
    mode = args.processing_mode
    # stage tracking runs the plain ISP (the JAX package builds its Pallas
    # ISP only without tracked stages)
    track = args.track_processing or args.track_processing_gradients
    if mode == "static":
        return _StaticAsModule(_static_pipeline(args, dataset),
                               stats["mean"], stats["std"], device)
    if mode == "parametrized":
        return ParametrizedProcessing(
            camera_parameters=dataset.camera_parameters,
            batch_norm_output=True,
            track_stages=track,
            additive_layer=args.adv_training and args.adv_noise_layer,
            image_size=image_size, use_kernel=args.use_pallas and not track,
            device=device)
    # Drone's statistics have no mosaic entries: no normalisation
    mosaic = {"normalize_mosaic_mean": stats.get("mosaic_mean"),
              "normalize_mosaic_std": stats.get("mosaic_std")}
    if mode == "neural_network":
        return NNProcessing(device=device, generator=generator, **mosaic)
    return RawToRGB(device=device, **mosaic)


def compute_dtype(args):
    """The task model's compute dtype from ``--compute_dtype``."""
    return (torch.bfloat16 if args.compute_dtype == "bfloat16"
            else torch.float32)


def build_classifier(args, dataset, device, generator):
    """The task model in ``--compute_dtype``: a ResNet for classification
    (raising here when ``--classifier_pretrained`` has no weights file),
    a U-Net++ on ``--smp_encoder`` for segmentation, its init drawn from
    ``generator``."""
    if dataset.task == "classification":
        return resnet_model(model=args.classifier_network.lower(),
                            pretrained=args.classifier_pretrained,
                            fc_out_features=len(dataset.classes),
                            dtype=compute_dtype(args), device=device,
                            generator=generator)
    return UNetPlusPlus(encoder_name=args.smp_encoder, encoder_depth=5,
                        decoder_channels=(256, 128, 64, 32, 16),
                        in_channels=3, classes=1, device=device,
                        generator=generator, dtype=compute_dtype(args))


def overlay_imagenet_weights(args, task, processor, classifier):
    """The JAX CLI's ImageNet overlays (``weights/<model>.npz``): the
    classifier's backbone with ``--classifier_pretrained`` (required), a
    U-Net++ encoder with its full stem and the neural ISP's depth-3
    resnet34 encoder whenever their file exists (best-effort). Returns the
    applied keys."""
    applied = []
    if task == "classification" and args.classifier_pretrained:
        applied = load_pretrained_variables(
            args.classifier_network.lower(), classifier)
    elif task == "segmentation":
        applied = load_pretrained_variables(
            args.smp_encoder.lower(), classifier, prefix=("encoder",),
            required=False)
    if applied:
        print(f"applied {len(applied)} pretrained arrays to the classifier "
              f"backbone")
    if args.processing_mode == "neural_network" and processor is not None:
        proc_applied = load_pretrained_variables(
            "resnet34", processor, prefix=("model", "encoder"),
            required=False, ignore_missing=True)
        if proc_applied:
            print(f"applied {len(proc_applied)} pretrained arrays to the "
                  f"neural-ISP encoder")
        applied = applied + proc_applied
    return applied


class StepProfiler:
    """``--profile``: a ``torch.profiler`` trace of global train steps [1, 4)
    (step 0 warms up), written to ``<out_dir>/trace.json`` when the window
    closes, or by ``close`` when training ends inside it, with the port's
    spans (``tracing``) on for the window, so that the trace holds the
    steps' stages and the loader's waits as ``r2l.`` ranges. Call
    ``before`` and ``after`` around each step; with ``out_dir`` None it
    does nothing. It only observes: what is trained is the same."""

    FIRST, END = 1, 4

    def __init__(self, out_dir, device):
        self.out_dir, self.device = out_dir, device
        self.steps, self.prof = 0, None

    def before(self):
        if self.out_dir is not None and self.steps == self.FIRST:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()
            tracing.enable()

    def after(self):
        self.steps += 1
        if self.steps == self.END:
            self.close()

    def close(self):
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        tracing.disable()
        self.prof.export_chrome_trace(os.path.join(self.out_dir,
                                                   "trace.json"))
        self.prof = None


def _epoch_means(metrics, weights=None):
    """Per key, the mean of the steps' values (weighted by ``weights``)."""
    w = np.ones(len(metrics)) if weights is None else np.asarray(
        weights, np.float64)
    w = w / w.sum()
    return {k: float(np.sum(w * np.asarray([float(m[k]) for m in metrics])))
            for k in metrics[0]}


def data_parallel_devices(args, device):
    """(the group's size, this rank's device). One process per device:
    without a group, ``--n_devices`` above 1 raises and says how to start
    the ranks; in a group ``--n_devices`` (default the group's size) must
    be its size, and each rank holds ``--batch_size`` / size rows."""
    _, size = distributed.world()
    n = args.n_devices
    if (n or 1) > 1 and size == 1:
        raise ValueError(
            f"--n_devices {n} trains with one process per device: start {n} "
            f"processes of this command with COORDINATOR_ADDRESS=<host>:"
            f"<port> (rank 0's) NUM_PROCESSES={n} PROCESS_ID=<0..{n - 1}> "
            f"in their environments (the JAX package drives every local "
            f"chip from one process; torch runs one per GPU)")
    if n not in (None, size) or args.batch_size % size:
        raise ValueError(
            f"the {size} processes of the group each hold --batch_size / "
            f"{size} rows: give a --batch_size that is a multiple of {size} "
            f"and --n_devices {size} (or none), not --batch_size "
            f"{args.batch_size} with --n_devices {n}")
    return size, (distributed.device(device.type) if size > 1 else device)


def _track(args, cfg, state, loader, save_loc, device):
    """The tracked stages of ``loader``'s images (``track_images``), on
    this process alone: nothing is reduced over the group."""
    if state.processor is None or args.processing_mode == "static":
        return
    reference = (state.ref_processor
                 if cfg.adv_training and args.adv_track_differences else None)
    with distributed.replicated():
        track_images(state.processor, state.classifier, task_loss_fn(cfg),
                     loader, reference=reference,
                     track_processing=args.track_processing,
                     track_gradients=args.track_processing_gradients,
                     track_predictions=args.track_predictions,
                     save_tensors=args.track_save_tensors,
                     save_loc=save_loc, device=device)


def _validate(eval_step, state, loader, generator, device, size):
    """Size-weighted means of the eval step's metrics over ``loader``'s
    global batches, each rank evaluating its rows (a batch with fewer
    rows than ranks is evaluated whole on every rank)."""
    val_metrics, val_ns = [], []
    for raw, y in loader:
        val_ns.append(len(raw))
        whole = len(raw) < size
        with distributed.replicated() if whole else contextlib.nullcontext():
            if not whole:
                raw, y = distributed.shard(raw), distributed.shard(y)
            _, mets = eval_step(state, torch.as_tensor(raw, device=device),
                                torch.as_tensor(y, device=device), generator)
        val_metrics.append(mets)
    return val_metrics, val_ns


def run_train(args):
    print(args)
    if args.fuse_opt and not args.staged_step:
        raise SystemExit("--fuse_opt requires --staged_step (the "
                         "monolith already fuses the optimizer)")
    device = resolve_device(None if args.device == "cuda" else args.device)
    distributed.initialize(backend="gloo" if device.type == "cpu" else None)
    _, size = distributed.world()
    primary = distributed.is_primary()
    training_mode = "adversarial" if args.adv_training else "default"
    # the synthetic sets take no exposure: get_dataset drops it for them
    dataset = get_dataset(args.dataset, I_ratio=args.I_ratio)
    print(f"dataset: {type(dataset).__name__}[{len(dataset)}]")
    print(f"task: {dataset.task}")
    print(f"mode: {training_mode} training")
    print(f"# cross-validation subsets: {args.n_splits}")
    _refuse_unrunnable(args, dataset.task)

    if args.adv_training:
        assert args.processing_mode == "parametrized", \
            "processing_mode should be 'parametrized' for adversarial training"
        assert args.freeze_classifier, \
            "classifier should be frozen for adversarial training"
        assert not args.freeze_processor, \
            "processor should not be frozen for adversarial training"
    assert not (args.freeze_processor and args.freeze_classifier), \
        "Likely no parameters to train."

    n_devices, device = data_parallel_devices(args, device)
    print(f"data mesh: {n_devices} device(s)")
    idxs_kfold = k_fold(dataset, n_splits=args.n_splits, seed=args.seed,
                        train_size=args.train_size)
    image_size = dataset[0][0].shape[0]

    precompute = (args.processing_mode == "static"
                  and args.precompute_static)
    if precompute:
        # the deterministic ISP and the normalisation, once over the
        # dataset; every fold then trains the classifier on the cached RGB
        # (in-graph static mode runs pipeline -> normalisation ->
        # augmentation -> classifier in this order too)
        stats = dataset_stats(args.dataset)
        rgb = precompute_pipeline_rgb(
            dataset, _static_pipeline(args, dataset),
            batch_size=args.batch_size, device=device)
        rgb = ((rgb - np.asarray(stats["mean"], np.float32)[:, None, None])
               / np.asarray(stats["std"], np.float32)[:, None, None])
        dataset = PrecomputedRGBView(dataset, rgb)
        print(f"precomputed static ISP: {rgb.shape} cached")

    # cosine horizon: steps per fold (the train loader drops the ragged
    # tail)
    n_train = (args.batch_size if args.test_run
               else int(len(dataset) * args.train_size))
    steps_per_epoch = max(1, n_train // args.batch_size)
    cfg = TrainConfig(
        task=dataset.task, lr=args.lr, lr_schedule=args.lr_schedule,
        total_steps=steps_per_epoch * args.epochs,
        weight_decay=args.weight_decay, augmentation=args.augmentation,
        freeze_processor=(args.freeze_processor
                          or args.processing_mode == "static"),
        freeze_classifier=args.freeze_classifier,
        adv_training=args.adv_training, adv_aux_weight=args.adv_aux_weight,
        adv_aux_loss=args.adv_aux_loss,
        adv_parameters=args.adv_parameters or "all",
        loss_weight=-1.0 if args.adv_training else 1.0)

    # only the primary writes the run store
    parent = (Run(args.experiment_name, args.run_name,
                  tracking_uri=args.tracking_uri) if primary else None)
    results = []

    for k_iter, (train_indices, valid_indices) in enumerate(idxs_kfold):
        print(f"K_fold subset: {k_iter + 1}/{args.n_splits}")
        # with the precompute the ISP has already run
        # one stream, processor first: only the neural ISP draws from it,
        # so the other modes' task models start as seeded alone
        init = torch.Generator(device).manual_seed(args.seed)
        processor = (None if precompute
                     else build_processor(args, dataset, image_size, device,
                                          init))
        classifier = build_classifier(args, dataset, device, init)
        overlay_imagenet_weights(args, dataset.task, processor, classifier)

        state_dict = dict(vars(args))
        if args.state_dict_uri:
            with open(args.state_dict_uri) as fh:
                loaded = json.load(fh)
            train_indices = loaded["train_indices"]
            valid_indices = loaded["valid_indices"]
            state_dict.update(loaded)
        if dataset.task == "classification":
            state_dict["classes"] = dataset.classes
        state_dict["train_indices"] = list(map(int, train_indices))
        state_dict["valid_indices"] = list(map(int, valid_indices))
        state_dict["elements in train set"] = len(train_indices)
        state_dict["elements in test set"] = len(valid_indices)

        if args.test_run:
            train_indices = train_indices[: args.batch_size]
            valid_indices = valid_indices[: args.batch_size]

        train_loader = Loader(Subset(dataset, train_indices), args.batch_size,
                              shuffle=True, seed=args.seed)
        assert len(train_loader) > 0, (
            f"train split ({len(train_indices)} items) is smaller than "
            f"--batch_size {args.batch_size}; nothing would train")
        valid_loader = Loader(Subset(dataset, valid_indices), args.batch_size,
                              shuffle=False, drop_last=False)
        track_loader = Loader(Subset(dataset, list(range(
            args.track_n_images))), args.batch_size, shuffle=False,
            drop_last=False)

        run = parent.child(f"{args.run_name}_{k_iter}") if primary else None
        if primary:
            if not args.resume:
                # a fresh run into a reused directory must not append onto
                # an earlier attempt's metrics
                stale_metrics = os.path.join(run.dir, "metrics.jsonl")
                if os.path.exists(stale_metrics):
                    os.remove(stale_metrics)
            run.log_state_dict(state_dict)
            run.log_params({"dataset": args.dataset,
                            "processing_mode": args.processing_mode,
                            "training_mode": training_mode,
                            **({"adv_aux_weight": args.adv_aux_weight,
                                "adv_aux_loss": args.adv_aux_loss}
                               if args.adv_training else {})})
            with open(os.path.join(run.dir, "cli.txt"), "w") as fh:
                fh.write("python " + " ".join(sys.argv) + "\n")

        # the reference processor is the default processor as built (as
        # in the JAX package, --processor_uri loads the trained one only)
        state = create_train_state(cfg, processor, classifier,
                                   split_opt=args.fuse_opt)
        if args.processor_uri:
            ckpt.load_module(args.processor_uri, processor)
        if args.classifier_uri:
            ckpt.load_module(args.classifier_uri, classifier)
        train_step = (make_staged_train_step(cfg, processor, classifier,
                                             fuse_opt=args.fuse_opt)
                      if args.staged_step
                      else make_train_step(cfg, processor, classifier))
        eval_step = make_eval_step(cfg, processor, classifier)
        generator = torch.Generator().manual_seed(args.seed + k_iter)
        t0 = time.time()

        start_epoch = 0
        # every rank resumes from the checkpoints rank 0 writes
        ckpt_root = os.path.join(run_dir(args.experiment_name, args.run_name,
                                         f"{args.run_name}_{k_iter}"),
                                 "checkpoints")
        if args.resume and os.path.isdir(ckpt_root):
            epochs_done = sorted(
                int(m.group(1)) for f in os.listdir(ckpt_root)
                if (m := re.fullmatch(r"epoch_(\d+)\.pt", f)))
            if epochs_done:
                start_epoch = epochs_done[-1]
                ckpt.restore_state(os.path.join(
                    ckpt_root, f"epoch_{start_epoch:04d}.pt"), state)
                print(f"[fold {k_iter}] resumed from epoch {start_epoch}")

        # only the primary writes the trace
        profiler = StepProfiler(
            run.artifact_dir("profile") if primary and args.profile
            else None, device)
        for epoch in range(start_epoch, args.epochs):
            epoch_metrics = []
            for raw, y in train_loader:
                raw, y = distributed.shard(raw), distributed.shard(y)
                profiler.before()
                epoch_metrics.append(train_step(
                    state, torch.as_tensor(raw, device=device),
                    torch.as_tensor(y, device=device), generator))
                profiler.after()
            train_mets = {f"train_{k}": v
                          for k, v in _epoch_means(epoch_metrics).items()}
            if primary:
                run.log_metrics(train_mets, step=epoch)

            if (args.check_val_every_n_epoch > 0
                    and (epoch + 1) % args.check_val_every_n_epoch == 0):
                val_metrics, val_ns = _validate(eval_step, state,
                                                valid_loader, generator,
                                                device, size)
                # size-weighted: the ragged last batch counts by its size
                val_mets = {f"val_{k}": v for k, v in
                            _epoch_means(val_metrics, val_ns).items()}
                if primary:
                    run.log_metrics(val_mets, step=epoch)
                print(f"[fold {k_iter}] epoch {epoch + 1}/{args.epochs} "
                      f"{train_mets} {val_mets}")

            if primary and args.track_processing and args.track_every_epoch:
                _track(args, cfg, state, track_loader, run.artifact_dir(
                    "results", f"epoch_{epoch + 1:04d}"), device)

            if (primary and args.checkpoint_every_n_epochs
                    and (epoch + 1) % args.checkpoint_every_n_epochs == 0):
                ckpt.save_state(state, os.path.join(
                    ckpt_root, f"epoch_{epoch + 1:04d}.pt"))

        profiler.close()  # training ended inside the trace window
        print(f"[fold {k_iter}] trained {args.epochs} epochs "
              f"in {time.time() - t0:.1f}s")

        if (primary and args.track_processing
                and not args.track_every_epoch):
            _track(args, cfg, state, track_loader,
                   run.artifact_dir("results"), device)

        if primary and args.log_model:
            # per-component files, what --processor_uri / --classifier_uri
            # read; a static run has no processor file
            if processor is not None and processor.state_dict():
                ckpt.save_module(processor, os.path.join(ckpt_root,
                                                         "processor.pt"))
            ckpt.save_module(classifier, os.path.join(ckpt_root,
                                                      "classifier.pt"))

        if primary and args.save_locally:
            local_dir = os.path.join("saved_models", args.experiment_name,
                                     f"{args.run_name}_{k_iter}")
            ckpt.save_state(state, os.path.join(local_dir, "state.pt"))
            with open(os.path.join(local_dir, "state_dict.json"), "w") as fh:
                json.dump(state_dict, fh, indent=2, default=str)
            print(f"saved locally -> {local_dir}")

        results.append({"state": state, "run": run,
                        "valid_indices": valid_indices})
        if primary:
            run.close()

    if primary:
        parent.close()
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs("results", exist_ok=True)
    had_group = torch.distributed.is_initialized()
    try:
        return run_train(args)
    finally:
        if not had_group:  # leave a group this run joined
            distributed.shutdown()


if __name__ == "__main__":
    main()
