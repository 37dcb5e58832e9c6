"""Training core (port of ``raw2logit_tpu/training/core.py``): the
configuration, the state, and the train and eval steps.

One train step: raw mosaics -> processor -> classifier -> task loss ->
backward -> Adam, in place on the modules. What the JAX package splits
into jitted programs, masks and pytrees is PyTorch idiom here:

  * the state holds the ``nn.Module``s themselves, which the step updates
    in place, with ``torch.optim.Adam`` and an optional scheduler;
  * freezing (``freeze_processor`` / ``freeze_classifier``) sets
    ``requires_grad=False`` and leaves those parameters out of the
    optimizer, where JAX labels them for ``optax.set_to_zero``;
  * a frozen module runs in eval mode, so its BN statistics do not move;
  * adversarial mode (drift forensics) keeps a frozen deep copy of the
    processor as the reference; the processor runs in eval mode (its BN
    statistics stay frozen), only the parameters whose names contain
    ``adv_parameters`` train, and the aux term compares the processor's
    output with the reference's. With ``adv_aux_loss='ssim'`` and the
    fused-kernel processor, the aux value and its gradient come from the
    SSIM aux kernel (``kernels.SSIMAux``), where the JAX package's staged
    step takes its Pallas kernel;
  * augmentation draws once per step from the step's ``torch.Generator``
    and is replayed on segmentation masks (``augment.py``);
  * under a process group (``parallel.distributed``) each rank steps on
    its B/N rows of the global batch and the step computes the
    single-device step on the global batch: the batch norms' statistics,
    the losses and the metrics are the global batch's, each rank
    backpropagates its 1/N share of the global loss, the parameter
    gradients are summed over the ranks before Adam, and the
    augmentation draws for the global batch on every rank (the same
    generator) and keeps this rank's rows of its noise plane.

``make_staged_train_step`` (the same update split into programs to fit a
TPU compile budget) and the flat and split optimizer forms (TPU
workarounds with the same update) are not ported: this step computes
their result.
"""

import copy
import dataclasses
import math
from typing import Any

import torch

from raw2logit_tpu_torch import losses as L
from raw2logit_tpu_torch.augment import get_augmentation
from raw2logit_tpu_torch.kernels.ssim_aux import SSIMAux
from raw2logit_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    task: str = "classification"          # 'classification' | 'segmentation'
    lr: float = 1e-5
    lr_schedule: str = "constant"         # 'constant' | 'cosine'
    total_steps: int = 0                  # cosine horizon (train steps)
    weight_decay: float = 0.0
    augmentation: str = "none"            # 'none' | 'weak' | 'strong'
    augmentation_on_eval: bool = False
    freeze_processor: bool = False
    freeze_classifier: bool = False
    adv_training: bool = False
    adv_aux_weight: float = 1.0
    adv_aux_loss: str = "ssim"            # 'l2' | 'ssim'
    adv_parameters: str = "all"           # 'all' | param-name substring
    loss_weight: float = 1.0              # -1 with adv_training


@dataclasses.dataclass
class TrainState:
    """The modules (updated in place), their optimizer and scheduler, the
    number of steps taken and, in adversarial mode, the frozen reference
    processor (eval mode, no gradients)."""
    step: int
    processor: Any
    classifier: Any
    optimizer: torch.optim.Optimizer
    scheduler: Any = None
    ref_processor: Any = None


def make_optimizer(cfg, processor, classifier):
    """Adam over the trainable parameters of both modules, and the
    cosine scheduler or None.

    torch Adam's ``weight_decay`` is coupled L2, as ``add_decayed_weights``
    before ``optax.adam`` in the JAX package; betas (0.9, 0.999) and eps
    1e-8 are optax's defaults. ``lr_schedule="cosine"`` is optax's
    ``cosine_decay_schedule(lr, total_steps)``: step k (from 0) uses
    lr * (1 + cos(pi * min(k, T) / T)) / 2. Frozen modules, and in
    adversarial mode the processor's parameters whose names do not contain
    ``adv_parameters`` (unless it is 'all'), get ``requires_grad=False``
    and stay out of the optimizer."""
    targeted = cfg.adv_training and cfg.adv_parameters != "all"
    params = []
    for module, frozen in ((processor, cfg.freeze_processor),
                           (classifier, cfg.freeze_classifier)):
        if module is None:
            continue
        if frozen:
            module.requires_grad_(False)
            continue
        for name, p in module.named_parameters():
            if (targeted and module is processor
                    and cfg.adv_parameters not in name):
                p.requires_grad_(False)
            elif p.requires_grad:
                params.append(p)
    if not params:
        raise ValueError("no parameters to train: both modules are frozen, "
                         "or no processor parameter matches adv_parameters")
    optimizer = torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.lr_schedule == "constant":
        return optimizer, None
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"lr_schedule must be 'constant' or 'cosine', got "
                         f"{cfg.lr_schedule!r}")
    if cfg.total_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs total_steps")
    horizon = cfg.total_steps
    return optimizer, torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda k: 0.5 * (1.0 + math.cos(math.pi * min(k, horizon) / horizon)))


def task_loss_fn(cfg):
    base = (L.cross_entropy_loss if cfg.task == "classification"
            else L.dice_loss)
    return L.weighted_loss(base, cfg.loss_weight)


def create_train_state(cfg, processor, classifier):
    """The state of a run that starts from the modules' current weights
    (``processor`` may be None when the classifier takes RGB). In
    adversarial mode the reference processor is a deep copy of
    ``processor`` as it is now."""
    get_augmentation(cfg.augmentation)  # raises on an unknown kind
    ref = None
    if cfg.adv_training:
        if processor is None:
            raise ValueError("adversarial training needs a processor")
        ref = copy.deepcopy(processor).eval().requires_grad_(False)
    optimizer, scheduler = make_optimizer(cfg, processor, classifier)
    return TrainState(step=0, processor=processor, classifier=classifier,
                      optimizer=optimizer, scheduler=scheduler,
                      ref_processor=ref)


def _forward(cfg, processor, classifier, raw, train, generator):
    """processor -> augmentation -> classifier, each module in train mode
    only while it is trained (the reference keeps frozen parts, and the
    processor in adversarial mode, in eval mode, so their BN statistics
    do not move). Returns (logits, rgb, the augmentation's draws or
    None)."""
    if processor is not None:
        processor.train(train and not cfg.freeze_processor
                        and not cfg.adv_training)
        rgb, _ = processor(raw)
    else:
        rgb = raw
    x, draws = rgb, None
    aug = get_augmentation(cfg.augmentation)
    if aug is not None and (train or cfg.augmentation_on_eval):
        if generator is None:
            raise ValueError(f"augmentation {cfg.augmentation!r} draws from "
                             f"the step's generator; pass one")
        draws = _draw(aug, generator, rgb)
        x = aug.apply(draws, rgb)
    classifier.train(train and not cfg.freeze_classifier)
    return classifier(x), rgb, draws


def _draw(aug, generator, rgb):
    """The augmentation's draws for ``rgb``; under a process group those of
    the global batch (every rank holding as many rows), with this rank's
    rows of the per-image draws."""
    if not distributed.active():
        return aug.draw(generator, rgb)
    n = len(rgb) * distributed.world()[1]
    draws = aug.draw(generator, rgb.new_empty((n,) + tuple(rgb.shape[1:])))
    lo, hi = distributed.rows(n)
    return {k: v[lo:hi] if torch.is_tensor(v) else v
            for k, v in draws.items()}


def _task_targets(cfg, logits, y, draws):
    """Segmentation logits (B, 1, H, W) -> (B, H, W), and the masks with
    the image's geometric augmentation replayed."""
    if cfg.task != "segmentation":
        return logits, y
    if draws is not None:
        y = get_augmentation(cfg.augmentation).apply(draws, y, is_mask=True)
    if logits.shape[1] == 1:
        logits = logits[:, 0]
    return logits, y


def _step_metrics(cfg, logits, y):
    if cfg.task == "classification":
        return {"accuracy": L.accuracy(logits, y)}
    return {"iou_score": L.iou_score(torch.sigmoid(logits), y)}


def _check_modules(state, processor, classifier):
    """A step runs the modules of the state it is given, which must be
    the ones it was made for."""
    if state.processor is not processor or state.classifier is not classifier:
        raise ValueError("the state holds other modules than the ones this "
                         "step was made for")


def _reference_rgb(state, raw):
    """The frozen reference processor's output (under ``no_grad``, so the
    fused-kernel processor launches its serving kernel)."""
    with torch.no_grad():
        return state.ref_processor(raw)[0]


def make_train_step(cfg, processor, classifier):
    """``step(state, raw, y, generator=None)`` -> metrics dict of device
    tensors (``loss``, ``loss_aux``, ``accuracy`` or ``iou_score``).

    raw: (B, H, W) mosaics (or (B, 3, H, W) RGB when ``processor`` is
    None); y: integer labels (B,) or masks (B, H, W). The step updates
    ``state``'s modules, optimizer, scheduler and step count in place,
    leaves the gradients in ``.grad``, and does not synchronise with the
    host unless an augmentation draws. ``generator`` (a CPU
    ``torch.Generator``) is where augmentation draws from. In adversarial
    mode ``loss`` is the task loss plus ``loss_aux``."""
    loss_fn = task_loss_fn(cfg)
    aux_fn = (L.aux_loss(cfg.adv_aux_loss, cfg.adv_aux_weight)
              if cfg.adv_training else None)
    # the JAX package's staged step takes its SSIM kernel exactly here
    aux_kernel = (aux_fn is not None and cfg.adv_aux_loss == "ssim"
                  and getattr(processor, "use_kernel", False)
                  and not getattr(processor, "track_stages", False))

    def step(state, raw, y, generator=None):
        _check_modules(state, processor, classifier)
        state.optimizer.zero_grad(set_to_none=True)
        logits, rgb, draws = _forward(cfg, state.processor,
                                      state.classifier, raw, True,
                                      generator)
        logits, y = _task_targets(cfg, logits, y, draws)
        loss = loss_fn(logits, y)
        loss_aux = torch.zeros((), device=loss.device)
        if aux_fn is not None:
            ref_rgb = _reference_rgb(state, raw)
            loss_aux = (distributed.batch_mean(SSIMAux.apply(
                ref_rgb, rgb.contiguous(), cfg.adv_aux_weight), len(rgb))
                if aux_kernel else aux_fn(ref_rgb, rgb))
            loss = loss + loss_aux
        distributed.backward(loss)
        distributed.all_reduce_grads(
            p for group in state.optimizer.param_groups
            for p in group["params"])
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        mets = _step_metrics(cfg, logits.detach(), y)
        mets["loss"] = loss.detach()
        mets["loss_aux"] = loss_aux.detach()
        return mets

    return step


def make_eval_step(cfg, processor, classifier):
    """``step(state, raw, y, generator=None)`` -> (logits, metrics): both
    modules in eval mode, no gradients; augmentation only with
    ``augmentation_on_eval``. In adversarial mode the loss includes the
    aux term, also reported as ``loss_aux`` (through ``ops.ssim`` or l2,
    as the JAX eval step)."""
    loss_fn = task_loss_fn(cfg)
    aux_fn = (L.aux_loss(cfg.adv_aux_loss, cfg.adv_aux_weight)
              if cfg.adv_training else None)

    @torch.no_grad()
    def step(state, raw, y, generator=None):
        _check_modules(state, processor, classifier)
        logits, rgb, draws = _forward(cfg, state.processor,
                                      state.classifier, raw, False,
                                      generator)
        logits, y = _task_targets(cfg, logits, y, draws)
        mets = _step_metrics(cfg, logits, y)
        loss = loss_fn(logits, y)
        if aux_fn is not None:
            mets["loss_aux"] = aux_fn(_reference_rgb(state, raw), rgb)
            loss = loss + mets["loss_aux"]
        mets["loss"] = loss
        return logits, mets

    return step
