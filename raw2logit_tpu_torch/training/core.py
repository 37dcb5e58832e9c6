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
  * a frozen module runs in eval mode, so its BN statistics do not move.

``make_staged_train_step`` (the same update split into programs to fit a
TPU compile budget) and the flat and split optimizer forms (TPU
workarounds with the same update) are not ported: this step computes
their result. Augmentation and adversarial training wait for the slices
that port them, and raise here.
"""

import dataclasses
import math
from typing import Any

import torch

from raw2logit_tpu_torch import losses as L


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
    """The modules (updated in place), their optimizer and scheduler, and
    the number of steps taken."""
    step: int
    processor: Any
    classifier: Any
    optimizer: torch.optim.Optimizer
    scheduler: Any = None


def _check_supported(cfg):
    if cfg.augmentation != "none" or cfg.augmentation_on_eval:
        raise NotImplementedError(
            "augmentation comes with the data and augmentation slice of the "
            "port; use augmentation='none'")
    if cfg.adv_training:
        raise NotImplementedError(
            "adversarial training comes with the adversarial slice of the "
            "port")


def make_optimizer(cfg, processor, classifier):
    """Adam over the trainable parameters of both modules, and the
    cosine scheduler or None.

    torch Adam's ``weight_decay`` is coupled L2, as ``add_decayed_weights``
    before ``optax.adam`` in the JAX package; betas (0.9, 0.999) and eps
    1e-8 are optax's defaults. ``lr_schedule="cosine"`` is optax's
    ``cosine_decay_schedule(lr, total_steps)``: step k (from 0) uses
    lr * (1 + cos(pi * min(k, T) / T)) / 2. Frozen modules get
    ``requires_grad=False`` and stay out of the optimizer."""
    params = []
    for module, frozen in ((processor, cfg.freeze_processor),
                           (classifier, cfg.freeze_classifier)):
        if module is None:
            continue
        if frozen:
            module.requires_grad_(False)
        else:
            params += [p for p in module.parameters() if p.requires_grad]
    if not params:
        raise ValueError("no parameters to train: both modules are frozen")
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
    (``processor`` may be None when the classifier takes RGB)."""
    _check_supported(cfg)
    optimizer, scheduler = make_optimizer(cfg, processor, classifier)
    return TrainState(step=0, processor=processor, classifier=classifier,
                      optimizer=optimizer, scheduler=scheduler)


def _forward(cfg, processor, classifier, raw, train):
    """processor -> classifier, each in train mode only while it is
    trained (the reference keeps frozen parts in eval mode, so their BN
    statistics do not move). Returns (logits, rgb)."""
    if processor is not None:
        processor.train(train and not cfg.freeze_processor
                        and not cfg.adv_training)
        rgb, _ = processor(raw)
    else:
        rgb = raw
    classifier.train(train and not cfg.freeze_classifier)
    return classifier(rgb), rgb


def _task_logits(cfg, logits):
    if cfg.task == "segmentation" and logits.shape[1] == 1:
        return logits[:, 0]
    return logits


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


def make_train_step(cfg, processor, classifier):
    """``step(state, raw, y, generator=None)`` -> metrics dict of device
    tensors (``loss``, ``loss_aux``, ``accuracy`` or ``iou_score``).

    raw: (B, H, W) mosaics (or (B, 3, H, W) RGB when ``processor`` is
    None); y: integer labels (B,) or masks (B, H, W). The step updates
    ``state``'s modules, optimizer, scheduler and step count in place,
    leaves the gradients in ``.grad``, and does not synchronise with the
    host. ``generator`` is where augmentation will draw from; it is
    unused while augmentation is 'none'."""
    _check_supported(cfg)
    loss_fn = task_loss_fn(cfg)

    def step(state, raw, y, generator=None):
        _check_modules(state, processor, classifier)
        state.optimizer.zero_grad(set_to_none=True)
        logits, _ = _forward(cfg, state.processor, state.classifier, raw,
                             train=True)
        logits = _task_logits(cfg, logits)
        loss = loss_fn(logits, y)
        loss.backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        mets = _step_metrics(cfg, logits.detach(), y)
        mets["loss"] = loss.detach()
        mets["loss_aux"] = torch.zeros((), device=loss.device)
        return mets

    return step


def make_eval_step(cfg, processor, classifier):
    """``step(state, raw, y, generator=None)`` -> (logits, metrics): both
    modules in eval mode, no gradients."""
    _check_supported(cfg)
    loss_fn = task_loss_fn(cfg)

    @torch.no_grad()
    def step(state, raw, y, generator=None):
        _check_modules(state, processor, classifier)
        logits, _ = _forward(cfg, state.processor, state.classifier, raw,
                             train=False)
        logits = _task_logits(cfg, logits)
        mets = _step_metrics(cfg, logits, y)
        mets["loss"] = loss_fn(logits, y)
        return logits, mets

    return step
