"""Training core (port of ``raw2logit_tpu/training/core.py``): the
configuration, the state, the optimizer forms, and the train steps (one
step, and the same update in stages) and the eval step.

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

``make_staged_train_step`` computes the same update as ``make_train_step``
in explicit stages with explicit tensors handed between them (JAX's
separately jitted programs), each stage calling the kernel wrappers
directly; ``make_optimizer``'s ``flat`` and ``split`` forms are the same
Adam over one flat buffer and over one optimizer per module (the split
pair is what the staged step's ``fuse_opt`` steps inside its stages).
"""

import copy
import dataclasses
import functools
import math
from typing import Any

import torch

from raw2logit_tpu_torch import losses as L
from raw2logit_tpu_torch import tracing
from raw2logit_tpu_torch.augment import get_augmentation
from raw2logit_tpu_torch.isp.batchnorm import bn_input_cotangent
from raw2logit_tpu_torch.kernels.fused_isp import fused_isp, fused_isp_train
from raw2logit_tpu_torch.kernels.fused_isp_bwd import fused_isp_bwd
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
    processor (eval mode, no gradients). A split state
    (``create_train_state(split_opt=True)``) holds the (processor side,
    classifier side) pair in ``optimizer`` and in ``scheduler``, with None
    for a side that has nothing to train or no schedule."""
    step: int
    processor: Any
    classifier: Any
    optimizer: Any
    scheduler: Any = None
    ref_processor: Any = None


class FlatAdam(torch.optim.Adam):
    """``torch.optim.Adam`` over one flat tensor that holds every parameter
    it is given: each parameter's data and its ``.grad`` become views into
    one contiguous buffer each, so one Adam update runs over all of them
    (JAX's ``make_optimizer(flat=True)`` ravels and unravels every step
    instead). ``zero_grad`` zeroes the gradient buffer in place, and
    autograd accumulates into its views. Moving a module to another
    device or dtype afterwards, or deep-copying it, breaks the views."""

    def __init__(self, params, **kwargs):
        params = list(params)
        if len({(p.dtype, p.device) for p in params}) != 1:
            raise ValueError("FlatAdam needs parameters of one dtype on one "
                             "device")
        flat = torch.nn.Parameter(torch.cat([p.detach().reshape(-1)
                                             for p in params]))
        flat.grad = torch.zeros_like(flat)
        offset = 0
        for p in params:
            n = p.numel()
            p.data = flat.data[offset:offset + n].view_as(p)
            p.grad = flat.grad[offset:offset + n].view_as(p)
            offset += n
        super().__init__([flat], **kwargs)

    def zero_grad(self, set_to_none=True):
        """Zero the gradient buffer in place (the parameters' ``.grad``
        stay its views, whatever ``set_to_none`` says)."""
        self.param_groups[0]["params"][0].grad.zero_()


def _trainable(cfg, module, frozen, targeted):
    """The parameters of ``module`` that train; the others (all of a
    frozen module's, and with ``targeted`` those whose names do not
    contain ``adv_parameters``) get ``requires_grad=False``."""
    if module is None:
        return []
    if frozen:
        module.requires_grad_(False)
        return []
    params = []
    for name, p in module.named_parameters():
        if targeted and cfg.adv_parameters not in name:
            p.requires_grad_(False)
        elif p.requires_grad:
            params.append(p)
    return params


def _scheduler(cfg, optimizer):
    """None for a constant learning rate, else the cosine ``LambdaLR``."""
    if cfg.lr_schedule == "constant":
        return None
    if cfg.lr_schedule != "cosine":
        raise ValueError(f"lr_schedule must be 'constant' or 'cosine', got "
                         f"{cfg.lr_schedule!r}")
    if cfg.total_steps <= 0:
        raise ValueError("lr_schedule='cosine' needs total_steps")
    horizon = cfg.total_steps
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        lambda k: 0.5 * (1.0 + math.cos(math.pi * min(k, horizon) / horizon)))


def make_optimizer(cfg, processor, classifier, flat=False, split=False):
    """Adam over the trainable parameters of both modules, and the
    cosine scheduler or None: ``(optimizer, scheduler)``.

    torch Adam's ``weight_decay`` is coupled L2, as ``add_decayed_weights``
    before ``optax.adam`` in the JAX package; betas (0.9, 0.999) and eps
    1e-8 are optax's defaults. ``lr_schedule="cosine"`` is optax's
    ``cosine_decay_schedule(lr, total_steps)``: step k (from 0) uses
    lr * (1 + cos(pi * min(k, T) / T)) / 2. Frozen modules, and in
    adversarial mode the processor's parameters whose names do not contain
    ``adv_parameters`` (unless it is 'all'), get ``requires_grad=False``
    and stay out of the optimizer.

    ``flat=True`` runs the Adam over one flat buffer (``FlatAdam``; the
    modules' parameters become views into it). ``split=True`` returns
    one ``(optimizer, scheduler)`` per module instead, (processor side,
    classifier side), with None for a side that has nothing to train
    (JAX's ``set_to_zero``). Every form builds ``torch.optim.Adam`` with
    torch's default implementation for its device (the per-tensor loop on
    the CPU, the foreach kernels on CUDA), so forms compared on one device
    run one implementation; Adam is elementwise, so both forms are then
    bitwise the per-leaf update."""
    if flat and split:
        raise ValueError("make_optimizer takes flat or split, not both")
    targeted = cfg.adv_training and cfg.adv_parameters != "all"
    sides = (_trainable(cfg, processor, cfg.freeze_processor, targeted),
             _trainable(cfg, classifier, cfg.freeze_classifier, False))
    if not any(sides):
        raise ValueError("no parameters to train: both modules are frozen, "
                         "or no processor parameter matches adv_parameters")

    def adam(params, cls=torch.optim.Adam):
        optimizer = cls(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                        weight_decay=cfg.weight_decay)
        return optimizer, _scheduler(cfg, optimizer)

    if split:
        return tuple(adam(params) if params else None for params in sides)
    return adam(sides[0] + sides[1], FlatAdam if flat else torch.optim.Adam)


def task_loss_fn(cfg):
    base = (L.cross_entropy_loss if cfg.task == "classification"
            else L.dice_loss)
    return L.weighted_loss(base, cfg.loss_weight)


def create_train_state(cfg, processor, classifier, split_opt=False):
    """The state of a run that starts from the modules' current weights
    (``processor`` may be None when the classifier takes RGB). In
    adversarial mode the reference processor is a deep copy of
    ``processor`` as it is now. ``split_opt`` holds
    ``make_optimizer(split=True)``'s pair, which the staged step with
    ``fuse_opt`` steps. Runs inside the span ``r2l.setup.state``."""
    with tracing.span("r2l.setup.state"):
        get_augmentation(cfg.augmentation)  # raises on an unknown kind
        ref = None
        if cfg.adv_training:
            if processor is None:
                raise ValueError("adversarial training needs a processor")
            ref = copy.deepcopy(processor).eval().requires_grad_(False)
        if split_opt:
            sides = make_optimizer(cfg, processor, classifier, split=True)
            optimizer, scheduler = (tuple(None if side is None else side[i]
                                          for side in sides) for i in (0, 1))
        else:
            optimizer, scheduler = make_optimizer(cfg, processor, classifier)
    return TrainState(step=0, processor=processor, classifier=classifier,
                      optimizer=optimizer, scheduler=scheduler,
                      ref_processor=ref)


def _sides(state):
    """The ``(optimizer, scheduler)`` pairs of ``state``: its one joint
    pair, or the sides of a split state that train."""
    if not isinstance(state.optimizer, tuple):
        return [(state.optimizer, state.scheduler)]
    return [side for side in zip(state.optimizer, state.scheduler)
            if side[0] is not None]


def _apply(optimizer, scheduler):
    """Sum ``optimizer``'s gradients over the ranks, then step it and its
    scheduler."""
    distributed.all_reduce_grads(p for group in optimizer.param_groups
                                 for p in group["params"])
    optimizer.step()
    if scheduler is not None:
        scheduler.step()


def _isp_trains_bn(cfg):
    """Whether a train step runs the processor in train mode: not while it
    is frozen, nor in adversarial mode, so that its BN statistics do not
    move then."""
    return not cfg.freeze_processor and not cfg.adv_training


def _fast(processor):
    """Whether ``processor`` is the fused-kernel processor (``use_kernel``
    without tracked stages; JAX's ``_pallas_fast``)."""
    return (processor is not None and getattr(processor, "use_kernel", False)
            and not getattr(processor, "track_stages", False))


def _process(cfg, processor, raw, train):
    """The processor's RGB (``raw`` itself without a processor), the
    processor in train mode only in a train step that trains its BN."""
    if processor is None:
        return raw
    processor.train(train and _isp_trains_bn(cfg))
    return processor(raw)[0]


def _forward(cfg, processor, classifier, raw, train, generator):
    """processor -> augmentation -> classifier, each module in train mode
    only while it is trained. Returns (logits, rgb, the augmentation's
    draws or None)."""
    rgb = _process(cfg, processor, raw, train)
    logits, draws = _classify(cfg, classifier, rgb, train, generator)
    return logits, rgb, draws


def _classify(cfg, classifier, rgb, train, generator):
    """augmentation -> classifier: (logits, the augmentation's draws or
    None)."""
    x, draws = rgb, None
    aug = get_augmentation(cfg.augmentation)
    if aug is not None and (train or cfg.augmentation_on_eval):
        if generator is None:
            raise ValueError(f"augmentation {cfg.augmentation!r} draws from "
                             f"the step's generator; pass one")
        draws = _draw(aug, generator, rgb)
        x = aug.apply(draws, rgb)
    classifier.train(train and not cfg.freeze_classifier)
    return classifier(x), draws


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


def _task_loss(cfg, loss_fn, classifier, rgb, y, generator):
    """augmentation -> classifier -> task loss of a train step from
    ``rgb``: (the loss, the step's task metrics)."""
    logits, draws = _classify(cfg, classifier, rgb, True, generator)
    logits, y = _task_targets(cfg, logits, y, draws)
    return loss_fn(logits, y), _step_metrics(cfg, logits.detach(), y)


def _aux_loss(cfg, aux_fn, kernel, ref, rgb):
    """The adversarial aux term of ``rgb`` against the reference's
    ``ref``: with ``kernel`` through the SSIM aux kernel (``SSIMAux``,
    the mean over the global batch under a process group), else
    ``aux_fn``."""
    if kernel:
        return distributed.batch_mean(SSIMAux.apply(
            ref, rgb.contiguous(), cfg.adv_aux_weight), len(rgb))
    return aux_fn(ref, rgb)


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


def _check_joint(state, fuse_opt=False):
    """The one step and the staged step without ``fuse_opt`` step a joint
    optimizer; the staged step with ``fuse_opt`` a split state's pair."""
    split = isinstance(state.optimizer, tuple)
    if split and not fuse_opt:
        raise ValueError("a split optimizer state (create_train_state("
                         "split_opt=True)) is stepped by "
                         "make_staged_train_step(fuse_opt=True)")
    if fuse_opt and not split:
        raise ValueError("fuse_opt=True needs the (processor side, "
                         "classifier side) pair of create_train_state("
                         "split_opt=True), not a joint optimizer")


def make_train_step(cfg, processor, classifier):
    """``step(state, raw, y, generator=None)`` -> metrics dict of device
    tensors (``loss``, ``loss_aux``, ``accuracy`` or ``iou_score``).

    raw: (B, H, W) mosaics (or (B, 3, H, W) RGB when ``processor`` is
    None); y: integer labels (B,) or masks (B, H, W). The step updates
    ``state``'s modules, optimizer, scheduler and step count in place,
    leaves the gradients in ``.grad``, and does not synchronise with the
    host unless an augmentation draws. ``generator`` (a CPU
    ``torch.Generator``) is where augmentation draws from. In adversarial
    mode ``loss`` is the task loss plus ``loss_aux``.

    A step runs inside the span ``r2l.step``, its stages inside its
    children ``r2l.step.process`` (the processor), ``.task``
    (augmentation, task model, loss), ``.aux`` (adversarial: the
    reference's RGB and the aux term), ``.backward`` and ``.optimizer``
    (the gradients' sum over the ranks, Adam, the scheduler)."""
    loss_fn = task_loss_fn(cfg)
    aux_fn = (L.aux_loss(cfg.adv_aux_loss, cfg.adv_aux_weight)
              if cfg.adv_training else None)
    # the JAX package's staged step takes its SSIM kernel exactly here
    aux_kernel = (aux_fn is not None and cfg.adv_aux_loss == "ssim"
                  and _fast(processor))

    def step(state, raw, y, generator=None):
        with tracing.span("r2l.step"):
            _check_modules(state, processor, classifier)
            _check_joint(state)
            state.optimizer.zero_grad(set_to_none=True)
            with tracing.span("r2l.step.process"):
                rgb = _process(cfg, state.processor, raw, True)
            with tracing.span("r2l.step.task"):
                loss, mets = _task_loss(cfg, loss_fn, state.classifier, rgb,
                                        y, generator)
            loss_aux = torch.zeros((), device=loss.device)
            if aux_fn is not None:
                with tracing.span("r2l.step.aux"):
                    loss_aux = _aux_loss(cfg, aux_fn, aux_kernel,
                                         _reference_rgb(state, raw), rgb)
                loss = loss + loss_aux
            with tracing.span("r2l.step.backward"):
                distributed.backward(loss)
            with tracing.span("r2l.step.optimizer"):
                _apply(state.optimizer, state.scheduler)
            state.step += 1
            return dict(mets, loss=loss.detach(), loss_aux=loss_aux.detach())

    return step


@dataclasses.dataclass
class Handoff:
    """What the stages of the staged step hand each other: ``x``, the
    tensor ``clf_grad`` starts from (the processor's RGB, or with
    ``clf_grad_bn`` its input to the output BN); ``res``, the fused
    training kernel's residual planes; ``graph``, the RGB with its
    autograd graph (``isp_residuals``); ``d``, the cotangent of ``x``."""
    x: Any
    res: Any = None
    graph: Any = None
    d: Any = None


def _trains(module):
    return module is not None and any(p.requires_grad
                                      for p in module.parameters())


def _accumulate(param, grad):
    """Add ``grad`` to ``param.grad`` as autograd does: the first gradient
    is taken as it is, a later one (or a ``FlatAdam`` view) is added."""
    if param.grad is None:
        param.grad = grad
    else:
        param.grad.add_(grad)


def make_staged_train_step(cfg, processor, classifier, donate=True,
                           fuse_opt=False, isp_residuals=False):
    """The update of ``make_train_step`` in explicit stages (JAX's
    separately jitted programs), with the same ``step(state, raw, y,
    generator=None)`` contract and metrics. Each stage calls the kernel
    wrappers directly and hands the next explicit tensors (``Handoff``),
    not one autograd graph:

    1. ``isp_fwd`` (no grad): with the fused-kernel processor (its
       ``use_kernel`` without tracked stages) the training kernel's RGB and
       residual planes (``fused_isp_train``; the serving kernel where no
       kernel parameter trains), the additive layer, and the output BN in
       eval mode; a train-mode BN runs in ``clf_grad_bn`` instead (JAX's
       ``bn_in_clf``). Another processor runs its forward; with
       ``isp_residuals`` (a trained processor without the kernel) under
       autograd, whose graph is kept for ``isp_bwd`` (JAX's saved
       residuals).
    2. ``clf_grad`` / ``clf_grad_bn``: from ``x`` as a detached leaf, (the
       train-mode output BN,) the augmentation drawn once from
       ``generator`` and replayed on masks, the classifier, the loss and
       its backward: the classifier's ``.grad`` and ``d``. With
       ``fuse_opt`` the classifier side's Adam and scheduler step here.
    3. ``aux_grad`` (adversarial): the frozen reference's RGB, the aux
       value and its gradient (with the kernel processor and the SSIM aux,
       ``SSIMAux``, whose forward launches ``ssim_aux_value_grad`` once;
       else autograd of the aux loss) added to ``d``.
    4. ``isp_bwd`` (when a processor parameter trains): with the kernel
       processor, the eval-mode BN's input cotangent and the residual
       backward kernel (``fused_isp_bwd`` with ``res``) into the
       processor's ``.grad``, the additive layer's the batch sum of ``d``;
       else the backward of the graph kept in stage 1, or of the processor
       forward recomputed under autograd (on copies of its buffers, so
       running statistics move once). With ``fuse_opt`` the processor
       side's Adam steps here.
    5. ``opt_apply`` (without ``fuse_opt``): the joint Adam and scheduler.

    ``step.programs`` maps these names to the stage callables, each
    running inside the span ``r2l.staged.<name>`` (``tracing``);
    ``step`` looks each stage up there when it runs, so a stage replaced
    in ``step.programs`` is the one that runs. ``step.fuse_opt`` and
    ``step.isp_residuals`` say which form this is. ``fuse_opt`` needs the split state of ``create_train_state(split_opt=
    True)`` (and raises on a joint one): Adam is per leaf, and the
    classifier's update touches nothing that stages 3 and 4 read, so the
    result is the joint update's. Under a process group each side's
    gradients are summed over the ranks before its Adam, and the step
    computes the one-rank step on the global batch, as the one step does.
    ``donate`` is accepted for the JAX signature and changes nothing (the
    port updates in place). JAX's ``cost_entries`` (XLA cost analysis) has
    no counterpart here: ``chip_smoke.py``'s ``KERNEL_COST`` counts the
    kernels' bytes and operations."""
    del donate
    loss_fn = task_loss_fn(cfg)
    aux_fn = (L.aux_loss(cfg.adv_aux_loss, cfg.adv_aux_weight)
              if cfg.adv_training else None)
    update_proc_bn = _isp_trains_bn(cfg)
    fast = _fast(processor)
    bn_in_clf = (fast and update_proc_bn
                 and processor.batch_norm is not None)
    residuals = bool(isp_residuals) and not fast and processor is not None
    aux_kernel = aux_fn is not None and fast and cfg.adv_aux_loss == "ssim"

    def side(state, i):
        """The split state's side i (0 processor, 1 classifier), or
        None."""
        return (None if state.optimizer[i] is None
                else (state.optimizer[i], state.scheduler[i]))

    def isp_fwd(state, raw):
        p = state.processor
        if p is None:
            return Handoff(x=raw)
        p.train(update_proc_bn)
        if residuals and _trains(p):
            rgb, _ = p(raw)
            return Handoff(x=rgb.detach(), graph=rgb)
        with torch.no_grad():
            if not fast:
                return Handoff(x=p(raw)[0])
            params = p.kernel_params()
            if any(t.requires_grad for t in params.values()):
                x, res = fused_isp_train(raw, params)
            else:  # an attack on the additive layer alone, or frozen
                x, res = fused_isp(raw, params), None
            if p.additive_layer is not None:
                x = x + p.additive_layer
            if p.batch_norm is not None and not bn_in_clf:
                x = p.batch_norm(x)  # eval mode
            return Handoff(x=x, res=res)

    def clf_grad(state, h, y, generator, bn=False):
        x = h.x.detach().requires_grad_(_trains(state.processor))
        rgb = state.processor.batch_norm(x) if bn else x
        loss, mets = _task_loss(cfg, loss_fn, state.classifier, rgb, y,
                                generator)
        distributed.backward(loss)
        h.d = x.grad
        if fuse_opt and side(state, 1) is not None:
            _apply(*side(state, 1))
        return dict(mets, loss=loss.detach(),
                    loss_aux=torch.zeros((), device=loss.device))

    def aux_grad(state, h, raw, mets):
        x = h.x.detach().requires_grad_(True)
        loss_aux = _aux_loss(cfg, aux_fn, aux_kernel,
                             _reference_rgb(state, raw), x)
        distributed.backward(loss_aux)
        h.d = h.d + x.grad
        loss_aux = loss_aux.detach()
        return dict(mets, loss=mets["loss"] + loss_aux, loss_aux=loss_aux)

    def isp_bwd(state, h, raw):
        p = state.processor
        if h.graph is not None:
            torch.autograd.backward(h.graph, h.d)
        elif not fast:
            buffers = {n: b.clone() for n, b in p.named_buffers()}
            rgb = torch.func.functional_call(p, buffers, (raw,))[0]
            torch.autograd.backward(rgb, h.d)
        else:
            d = h.d
            if p.batch_norm is not None and not bn_in_clf:
                bn = p.batch_norm
                d = bn_input_cotangent(None, d, {"var": bn.running_var},
                                       False, epsilon=bn.eps)
            params = p.kernel_params()
            if h.res is not None:
                _, grads = fused_isp_bwd(raw, params, d.contiguous(),
                                         res=h.res)
                for name, t in params.items():
                    if t.requires_grad:
                        _accumulate(t, grads[name])
            if p.additive_layer is not None and p.additive_layer.requires_grad:
                _accumulate(p.additive_layer, d.sum(0, keepdim=True))
        if fuse_opt and side(state, 0) is not None:
            _apply(*side(state, 0))

    def opt_apply(state):
        _apply(state.optimizer, state.scheduler)

    programs = {"isp_fwd": isp_fwd, "clf_grad": clf_grad,
                "isp_bwd": isp_bwd}
    if bn_in_clf:
        programs["clf_grad_bn"] = functools.partial(clf_grad, bn=True)
    if aux_fn is not None:
        programs["aux_grad"] = aux_grad
    if not fuse_opt:
        programs["opt_apply"] = opt_apply
    programs = {name: tracing.span(f"r2l.staged.{name}", fn)
                for name, fn in programs.items()}
    grad_stage = "clf_grad_bn" if bn_in_clf else "clf_grad"

    def step(state, raw, y, generator=None):
        _check_modules(state, processor, classifier)
        _check_joint(state, fuse_opt)
        for optimizer, _ in _sides(state):
            optimizer.zero_grad(set_to_none=True)
        h = programs["isp_fwd"](state, raw)
        mets = programs[grad_stage](state, h, y, generator)
        if aux_fn is not None:
            mets = programs["aux_grad"](state, h, raw, mets)
        if _trains(state.processor):
            programs["isp_bwd"](state, h, raw)
        if not fuse_opt:
            programs["opt_apply"](state)
        state.step += 1
        return mets

    step.programs = programs
    step.fuse_opt = fuse_opt
    step.isp_residuals = residuals
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
