"""Per-stage image, gradient and difference tracking (port of
``raw2logit_tpu/tracking/images.py``).

For a tracking subset: each processing stage saved as a tensor (.npy)
and a PNG grid, the task loss's gradient at every stage (through
zero-valued taps added at the stages, where the reference used
``retain_grad``), and each stage's difference from a reference
processor's (the adversarial drift). The CLI's ``--track_*`` writes them
under the run's ``results/``, with the JAX package's file names. Arrays
are the port's planar layout: (B, C, H, W) stages, (B,) labels or
(B, 1, H, W) masks. PIL is imported where a grid is written only.
"""

import os
from collections import defaultdict

import numpy as np
import torch

# pipeline order of the stage-tracking protocol (the reference's
# figures/figures.py): artifact numbering follows it
STAGE_ORDER = ("demosaic", "color_correct", "sharpening", "gaussian",
               "clipped", "gamma_correct", "noise", "rgb")


def _numpy(batch):
    return np.asarray(batch.detach().cpu() if torch.is_tensor(batch)
                      else batch)


def save_image_grid(batch, path, nrow=8):
    """Save a batch as one PNG grid: (B, C, H, W) with C 1 or 3, or (B, H,
    W), a tensor or an array; values clipped to [0, 1], 2-pixel gaps (the
    JAX package's grid of the same images in NHWC, pixel for pixel)."""
    from PIL import Image
    x = _numpy(batch).astype(np.float32)
    x = x[..., None] if x.ndim == 3 else np.moveaxis(x, 1, -1)
    b, h, w, c = x.shape
    ncol = min(nrow, b)
    nr = (b + ncol - 1) // ncol
    pad = 2
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        grid[pad + r * (h + pad): pad + r * (h + pad) + h,
             pad + col * (w + pad): pad + col * (w + pad) + w] = x[i]
    grid = np.clip(grid, 0.0, 1.0)
    if c == 1:
        grid = grid[..., 0]
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)


def log_tensor(batch, path, save_tensors=True, nrow=8):
    """Save ``batch`` as ``path`` (.npy, with ``save_tensors``) and as a PNG
    grid beside it, ``img_<name>.png``."""
    if save_tensors:
        np.save(path, _numpy(batch))
    head, tail = os.path.split(path)
    save_image_grid(batch, os.path.join(head, "img_" + tail.replace(
        ".npy", ".png")), nrow=nrow)


def make_stage_gradients_fn(processor, classifier, loss_fn,
                            with_reference=False, with_logits=False):
    """``fn(raw, labels, reference=None)`` -> (stages, grads, logits or
    None, the reference processor's stages or {}): the processor's stages
    in eval mode, the task loss's gradient at each (zero-valued taps),
    the logits of the same forward and, ``with_reference``, the stages of
    ``reference``. Both modules run in eval mode and get their modes
    back."""

    def fn(raw, labels, reference=None):
        modes = (processor.training, classifier.training)
        processor.eval()
        classifier.eval()
        try:
            with torch.no_grad():
                _, stages = processor(raw)
            if not stages:
                return {}, {}, None, {}
            taps = {k: torch.zeros_like(v, requires_grad=True)
                    for k, v in stages.items()}
            with torch.enable_grad():
                rgb, stages = processor(raw, taps=taps)
                logits = classifier(rgb)
                squeezed = (logits[:, 0] if logits.ndim == 4
                            and logits.shape[1] == 1 else logits)
                loss = loss_fn(squeezed, labels)
                grads = dict(zip(taps, torch.autograd.grad(
                    loss, list(taps.values()), allow_unused=True)))
            grads = {k: torch.zeros_like(taps[k]) if g is None else g
                     for k, g in grads.items()}
            ref_stages = {}
            if with_reference:
                with torch.no_grad():
                    _, ref_stages = reference(raw)
            return ({k: v.detach() for k, v in stages.items()}, grads,
                    logits.detach() if with_logits else None, ref_stages)
        finally:
            processor.train(modes[0])
            classifier.train(modes[1])

    return fn


def stage_gradients(processor, classifier, loss_fn, raw, labels):
    """The gradient of the task loss at every processing stage: (stages,
    grads), two dicts of planar tensors."""
    stages, grads, _, _ = make_stage_gradients_fn(
        processor, classifier, loss_fn)(raw, labels)
    return stages, grads


def track_images(processor, classifier, loss_fn, loader, reference=None,
                 track_processing=True, track_gradients=True,
                 track_predictions=True, save_tensors=True,
                 save_loc="results", device=None):
    """Write the stages, their gradients (normalised to [0, 1] over the
    subset) and their differences from ``reference`` (a processor) for
    every batch of ``loader`` ((raw, labels) numpy batches, moved to
    ``device``, by default the classifier's), and the targets and
    predictions; nothing for a processor without stages (static
    processing)."""
    os.makedirs(save_loc, exist_ok=True)
    if device is None:
        device = next(classifier.parameters()).device
    stages_full = defaultdict(list)
    grads_full = defaultdict(list)
    diffs_full = defaultdict(list)
    labels_full, logits_full = [], []

    track_differences = reference is not None
    batch_fn = make_stage_gradients_fn(processor, classifier, loss_fn,
                                       with_reference=track_differences,
                                       with_logits=track_predictions)
    for raw, labels in loader:
        stages, grads, logits, ref_stages = batch_fn(
            torch.as_tensor(raw, device=device),
            torch.as_tensor(labels, device=device), reference)
        if not stages:
            return
        if track_predictions:
            labels_full.append(np.asarray(labels))
            logits_full.append(_numpy(logits))
        for name, batch in stages.items():
            stages_full[name].append(_numpy(batch))
            if track_differences:
                diffs_full[name].append(_numpy(ref_stages[name] - batch))
            if track_gradients:
                grads_full[name].append(_numpy(grads[name]))

    ordered = ([n for n in STAGE_ORDER if n in stages_full]
               + [n for n in stages_full if n not in STAGE_ORDER])
    for stage_nr, name in enumerate(ordered):
        if track_processing:
            log_tensor(np.concatenate(stages_full[name]), os.path.join(
                save_loc, f"processing_{stage_nr}_{name}.npy"), save_tensors)
        if track_differences:
            log_tensor(np.concatenate(diffs_full[name]), os.path.join(
                save_loc, f"diffs_{stage_nr}_{name}.npy"), False)
        if track_gradients:
            g = np.abs(np.concatenate(grads_full[name]))
            rng = g.max() - g.min()
            g = (g - g.min()) / (rng if rng > 0 else 1.0)
            log_tensor(g, os.path.join(
                save_loc, f"gradients_{stage_nr}_{name}.npy"), save_tensors)

    if track_predictions and labels_full:
        labels = np.concatenate(labels_full)
        logits = np.concatenate(logits_full)
        if labels.ndim >= 3:  # segmentation masks
            log_tensor(labels[:, None] if labels.ndim == 3 else labels,
                       os.path.join(save_loc, "targets.npy"), save_tensors)
            log_tensor(logits, os.path.join(save_loc, "preds.npy"),
                       save_tensors)
        else:
            np.save(os.path.join(save_loc, "targets.npy"), labels)
            np.save(os.path.join(save_loc, "preds.npy"), logits)
