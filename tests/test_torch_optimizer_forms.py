"""The optimizer forms of ``make_optimizer`` (``flat``: one Adam over one
flat buffer; ``split``: one Adam per module) against the joint per-leaf
Adam, the staged step with ``fuse_opt`` against the staged step without
it, and checkpoints of a split state (``save_state``, ``restore_state``,
``restore_like``).

Adam is elementwise, so each form is held bitwise: every form builds
``torch.optim.Adam`` with torch's default for the device, so both sides
of each comparison run one implementation (on the CPU the per-tensor
loop). On the CPU, at a small
size (B = 4, 32x32 mosaics, a narrow ResNet).
"""

import numpy as np
import pytest
import torch

from raw2logit_tpu_torch.training import (TrainConfig, TrainState,
                                          create_train_state, make_optimizer,
                                          make_staged_train_step,
                                          make_train_step)
from raw2logit_tpu_torch.training.checkpoint import (restore_like,
                                                     restore_state,
                                                     save_state)
from test_torch_staged import (modules, mosaics,  # noqa: F401
                               one_torch_thread)

FROZEN = {"none": {}, "processor": {"freeze_processor": True},
          "classifier": {"freeze_classifier": True}}


def params_of(proc, clf):
    return {f"{m}.{n}": p for m, module in (("isp", proc), ("clf", clf))
            for n, p in module.named_parameters()}


def assert_equal(got, want):
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("form", ["flat", "split"])
@pytest.mark.parametrize("frozen", sorted(FROZEN))
def test_optimizer_form_is_bitwise_the_joint_adam(form, frozen):
    """Three Adam steps with coupled weight decay and the cosine schedule
    on the same seeded gradients: the flat and split forms leave every
    parameter bitwise where the joint per-leaf Adam does, and a frozen
    side where it was (split: that side has no optimizer)."""
    cfg = TrainConfig(lr=1e-2, weight_decay=1e-2, lr_schedule="cosine",
                      total_steps=3, **FROZEN[frozen])
    runs = {}
    for kind in ("joint", form):
        proc, clf = modules("classification", True)
        start = {n: p.detach().clone()
                 for n, p in params_of(proc, clf).items()}
        got = make_optimizer(cfg, proc, clf, flat=kind == "flat",
                             split=kind == "split")
        sides = [s for s in got if s is not None] if kind == "split" else [
            got]
        if kind == "split":
            assert (got[0] is None) == (frozen == "processor")
            assert (got[1] is None) == (frozen == "classifier")
        gen = torch.Generator().manual_seed(4)
        for _ in range(3):
            for optimizer, _ in sides:
                optimizer.zero_grad()
            for p in params_of(proc, clf).values():
                g = torch.randn(p.shape, generator=gen)
                if p.requires_grad:
                    if p.grad is None:
                        p.grad = g
                    else:
                        p.grad.copy_(g)
            for optimizer, scheduler in sides:
                optimizer.step()
                scheduler.step()
        runs[kind] = {n: p.detach() for n, p in params_of(proc, clf).items()}
        for name, p in params_of(proc, clf).items():
            moved = not torch.equal(p.detach(), start[name])
            assert moved == (not name.startswith(
                {"processor": "isp.", "classifier": "clf."}.get(
                    frozen, "none"))), name
    assert_equal(runs[form], runs["joint"])


def test_flat_form_keeps_the_modules_parameters_as_views():
    """``FlatAdam``: each parameter and its gradient are views into one
    buffer each, so autograd's gradients reach the one update."""
    proc, clf = modules("classification", True)
    optimizer, _ = make_optimizer(TrainConfig(), proc, clf, flat=True)
    (flat,) = optimizer.param_groups[0]["params"]
    assert flat.numel() == sum(p.numel() for p in params_of(proc, clf)
                               .values())
    base = flat.untyped_storage().data_ptr()
    for p in params_of(proc, clf).values():
        assert p.untyped_storage().data_ptr() == base
        assert p.grad.untyped_storage().data_ptr() == (
            flat.grad.untyped_storage().data_ptr())
    with pytest.raises(ValueError, match="flat or split"):
        make_optimizer(TrainConfig(), proc, clf, flat=True, split=True)


CASES = {"kernel": ("classification", True, {}),
         "plain-seg": ("segmentation", False, {"augmentation": "weak"}),
         "adversarial": ("classification", True,
                         {"adv_training": True, "freeze_classifier": True,
                          "loss_weight": -1.0, "adv_aux_weight": -0.5})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fuse_opt_is_bitwise_the_unfused_staged_step(case):
    """Three staged steps with ``fuse_opt`` (Adam per side inside the
    stages) against three without it, from the same weights: the same
    gradients give bitwise the same parameters and running statistics."""
    task, use_kernel, kw = CASES[case]
    cfg = TrainConfig(lr=1e-3, weight_decay=1e-3, task=task, **kw)
    raw, y = mosaics(task)
    out = {}
    for fuse in (False, True):
        proc, clf = modules(task, use_kernel)
        state = create_train_state(cfg, proc, clf, split_opt=fuse)
        step = make_staged_train_step(cfg, proc, clf, fuse_opt=fuse)
        gen = torch.Generator().manual_seed(2)
        losses = [float(step(state, raw, y, gen)["loss"]) for _ in range(3)]
        out[fuse] = losses, {f"{m}.{n}": t.clone() for m, module in
                             (("isp", proc), ("clf", clf))
                             for n, t in module.state_dict().items()}
    assert out[True][0] == out[False][0]
    assert_equal(out[True][1], out[False][1])


def test_split_checkpoint_restores_and_continues(tmp_path):
    """A split state saved after one fuse_opt step and restored into a
    state of other weights (``restore_state``, and ``restore_like``, which
    leaves its argument as it is): the next step equals the uninterrupted
    run's bitwise, schedulers included; a joint state refuses it."""
    cfg = TrainConfig(lr=1e-3, lr_schedule="cosine", total_steps=4)
    raw, y = mosaics("classification")

    def fresh(seed):
        proc, clf = modules("classification", True)
        if seed:
            with torch.no_grad():
                for p in clf.parameters():
                    p.add_(torch.randn(p.shape, generator=torch.Generator()
                                       .manual_seed(seed)))
        return create_train_state(cfg, proc, clf, split_opt=True)

    state = fresh(0)
    step = make_staged_train_step(cfg, state.processor, state.classifier,
                                  fuse_opt=True)
    step(state, raw, y)
    path = save_state(state, str(tmp_path / "ck" / "state.pt"))
    want = float(step(state, raw, y)["loss"])
    other = fresh(9)
    before = {n: t.clone() for n, t in other.classifier.state_dict().items()}
    like = restore_like(path, other)
    assert other.step == 0 and like.step == 1
    assert_equal(other.classifier.state_dict(), before)
    for restored in (like, restore_state(path, fresh(9))):
        assert [s.last_epoch for s in restored.scheduler] == [1, 1]
        got = make_staged_train_step(cfg, restored.processor,
                                     restored.classifier, fuse_opt=True)(
            restored, raw, y)
        assert float(got["loss"]) == want
        for a, b in ((restored.processor, state.processor),
                     (restored.classifier, state.classifier)):
            assert_equal(a.state_dict(), b.state_dict())
    joint = create_train_state(cfg, *modules("classification", True))
    with pytest.raises(ValueError, match="same --fuse_opt"):
        restore_state(path, joint)


def test_flat_state_steps_as_the_joint_state():
    """The one step on a state holding the flat form (``TrainState`` built
    from ``make_optimizer(flat=True)``) moves every parameter bitwise as
    on the joint state."""
    cfg = TrainConfig(lr=1e-3, weight_decay=1e-2)
    raw, y = mosaics("classification")
    out = {}
    for flat in (False, True):
        proc, clf = modules("classification", True)
        optimizer, scheduler = make_optimizer(cfg, proc, clf, flat=flat)
        state = TrainState(step=0, processor=proc, classifier=clf,
                           optimizer=optimizer, scheduler=scheduler)
        step = make_train_step(cfg, proc, clf)
        losses = [float(step(state, raw, y)["loss"]) for _ in range(3)]
        out[flat] = losses, {n: p.detach().clone()
                             for n, p in params_of(proc, clf).items()}
    assert out[True][0] == out[False][0]
    assert_equal(out[True][1], out[False][1])
    assert np.isfinite(out[True][0]).all()
