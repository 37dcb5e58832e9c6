"""Losses, regularizers, metrics (port of ``raw2logit_tpu/losses.py``).

Parity targets, as in the JAX package:
  * CrossEntropyLoss (mean over the batch, integer labels)
  * smp DiceLoss(mode='binary', from_logits=True)
  * WeightedLoss / AuxLoss / l2_regularization
  * accuracy / IoU metrics

Segmentation logits are NCHW: (B, 1, H, W) against (B, H, W) masks.

Under a process group (``parallel.distributed.active()``) every loss and
metric is the global batch's: each rank's sums over its rows are summed
over the ranks (``distributed.global_sum``) before the means and ratios
are taken. Without one they are computed as written, with no
collective.
"""

import torch
import torch.nn.functional as F

from raw2logit_tpu_torch.ops.ssim import ssim
from raw2logit_tpu_torch.parallel import distributed


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy with integer labels."""
    if distributed.active():
        return distributed.global_mean(
            F.cross_entropy(logits, labels, reduction="sum"), len(labels))
    return F.cross_entropy(logits, labels)


def dice_loss(logits, targets, smooth=0.0, eps=1e-7):
    """Binary soft-Dice on logits: ONE dice score over batch and space
    jointly, zeroed when the whole batch's target is empty (smp's
    ``y_true.sum(dims) > 0`` mask)."""
    probs = torch.sigmoid(logits).reshape(-1)
    targets = targets.reshape(-1).to(probs.dtype)
    intersection = torch.sum(probs * targets)
    cardinality = torch.sum(probs + targets)
    target_sum = torch.sum(targets)
    if distributed.active():
        intersection, cardinality, target_sum = distributed.global_sum(
            torch.stack([intersection, cardinality, target_sum]))
    score = (2.0 * intersection + smooth) / torch.clamp(
        cardinality + smooth, min=eps)
    has_target = (target_sum > 0).to(probs.dtype)
    return (1.0 - score) * has_target


def l2_regularization(x, y):
    """Sum of squared differences."""
    return distributed.global_sum(torch.sum((x - y) ** 2))


def weighted_loss(loss_fn, weight=1.0):
    """WeightedLoss: weight=-1 turns a task loss into the adversarial
    maximisation objective."""
    def _fn(*args, **kwargs):
        return weight * loss_fn(*args, **kwargs)
    return _fn


def aux_loss(regularization, weight=1.0):
    """AuxLoss: compare the adversarial processor's RGB output with the
    frozen default processor's, which gets no gradient: 'l2' (sum of
    squared differences) or 'ssim' (``ops.ssim.ssim``, the similarity
    itself: minimising ``weight * SSIM`` with a positive weight drives the
    outputs APART, so forensics runs with a negative weight)."""
    if regularization == "l2":
        reg = l2_regularization
    elif regularization == "ssim":
        reg = global_ssim
    else:
        raise NotImplementedError(regularization)

    def _fn(x_reference, x_processed):
        return weight * reg(x_reference.detach(), x_processed)
    return _fn


def global_ssim(x_reference, x_processed):
    """``ops.ssim.ssim`` (the mean over the batch), over the global batch
    under a process group."""
    return distributed.batch_mean(ssim(x_reference, x_processed),
                                  len(x_processed))


def accuracy(logits_or_preds, labels):
    """Classification accuracy; accepts logits (B, C) or integer preds."""
    if logits_or_preds.ndim > labels.ndim:
        preds = torch.argmax(logits_or_preds, dim=-1)
    else:
        preds = logits_or_preds
    hits = (preds == labels).to(torch.float32)
    if distributed.active():
        return distributed.global_mean(hits.sum(), len(labels))
    return torch.mean(hits)


def iou_score(logits_or_probs, targets, threshold=0.5, eps=1e-7,
              from_logits=False):
    """Binary IoU: threshold probabilities at 0.5, then intersection over
    union over the whole batch (the JAX package's deliberate deviation
    from the reference, which thresholded raw logits)."""
    probs = (torch.sigmoid(logits_or_probs) if from_logits
             else logits_or_probs)
    preds = (probs > threshold).to(torch.float32)
    targets = targets.to(torch.float32)
    if preds.ndim == targets.ndim + 1 and preds.shape[1] == 1:
        preds = preds[:, 0]
    intersection = torch.sum(preds * targets)
    union = torch.sum(preds) + torch.sum(targets) - intersection
    if distributed.active():
        intersection, union = distributed.global_sum(
            torch.stack([intersection, union]))
    return (intersection + eps) / (union + eps)
