"""Checkpoint and resume of a ``TrainState`` (port of
``raw2logit_tpu/training/checkpoint.py``).

One ``torch.save`` file holds the step count and the state dicts of the
processor, the classifier, the optimizer, the scheduler and, in
adversarial mode, the frozen reference processor. ``save_module`` and
``load_module`` write and read one module's state dict: the
per-component files that the CLI's ``--processor_uri`` and
``--classifier_uri`` read. They cannot read the JAX package's orbax
checkpoints; weights from there come across through
``raw2logit_tpu_torch.convert``.
"""

import os

import torch


def _state_dict(module):
    return None if module is None else module.state_dict()


def save_state(state, path):
    """Write ``state`` to ``path`` (parent directories are made)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({
        "step": state.step,
        "processor": _state_dict(state.processor),
        "classifier": state.classifier.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": _state_dict(state.scheduler),
        "ref_processor": _state_dict(state.ref_processor),
    }, path)
    return path


def restore_state(path, state):
    """Load the checkpoint at ``path`` into ``state`` (made by
    ``create_train_state`` with the same configuration and modules of the
    same shapes), in place, onto the devices its modules are on; returns
    ``state``."""
    device = next(state.classifier.parameters()).device
    ckpt = torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)
    for name in ("processor", "ref_processor"):
        module = getattr(state, name)
        if module is not None:
            module.load_state_dict(ckpt[name])
    state.classifier.load_state_dict(ckpt["classifier"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.scheduler is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = ckpt["step"]
    return state


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
