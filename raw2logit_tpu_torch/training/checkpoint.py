"""Checkpoint and resume of a ``TrainState`` (port of
``raw2logit_tpu/training/checkpoint.py``).

One ``torch.save`` file holds the step count and the state dicts of the
processor, the classifier, the optimizer, the scheduler and, in
adversarial mode, the frozen reference processor; a split state's
optimizers and schedulers as (processor side, classifier side) pairs.
``save_module`` and ``load_module`` write and read one module's state
dict: the
per-component files that the CLI's ``--processor_uri`` and
``--classifier_uri`` read. They cannot read the JAX package's orbax
checkpoints; weights from there come across through
``raw2logit_tpu_torch.convert``.
"""

import copy
import os

import torch


def _state_dict(obj):
    """``obj``'s state dict, None for None, and a tuple of them for a
    split state's pair."""
    if isinstance(obj, tuple):
        return tuple(map(_state_dict, obj))
    return None if obj is None else obj.state_dict()


def _load(obj, saved):
    """Load ``saved`` (as ``_state_dict`` wrote it) into ``obj``."""
    if isinstance(obj, tuple):
        for o, s in zip(obj, saved):
            _load(o, s)
    elif obj is not None:
        obj.load_state_dict(saved)


def save_state(state, path):
    """Write ``state`` to ``path`` (parent directories are made)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({
        "step": state.step,
        "processor": _state_dict(state.processor),
        "classifier": state.classifier.state_dict(),
        "optimizer": _state_dict(state.optimizer),
        "scheduler": _state_dict(state.scheduler),
        "ref_processor": _state_dict(state.ref_processor),
    }, path)
    return path


def restore_state(path, state):
    """Load the checkpoint at ``path`` into ``state`` (made by
    ``create_train_state`` with the same configuration, ``split_opt`` and
    modules of the same shapes), in place, onto the devices its modules
    are on; returns ``state``."""
    device = next(state.classifier.parameters()).device
    ckpt = torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
    if isinstance(state.optimizer, tuple) != isinstance(ckpt["optimizer"],
                                                        (tuple, list)):
        raise ValueError("a split state restores from a split state's "
                         "checkpoint, a joint one from a joint one's (the "
                         "same --fuse_opt)")
    for name in ("processor", "ref_processor", "classifier", "optimizer",
                 "scheduler"):
        _load(getattr(state, name), ckpt[name])
    state.step = ckpt["step"]
    return state


def restore_like(path, state):
    """A new state shaped like ``state`` (a deep copy: its modules,
    optimizers and schedulers) holding the checkpoint at ``path``;
    ``state`` itself is left as it is (the counterpart of the JAX
    package's ``restore_like``, which restores into the structure of a
    given state)."""
    return restore_state(path, copy.deepcopy(state))


def save_module(module, path):
    """Write ``module``'s state dict to ``path`` (parent directories are
    made); returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(module.state_dict(), path)
    return path


def load_module(path, module):
    """Load the state dict at ``path`` into ``module``, in place, onto the
    device of its parameters; returns ``module``."""
    device = next(module.parameters()).device
    module.load_state_dict(torch.load(os.path.abspath(path),
                                      map_location=device,
                                      weights_only=True))
    return module
