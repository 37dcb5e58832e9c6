"""Checkpoint and resume of a ``TrainState`` (port of
``raw2logit_tpu/training/checkpoint.py``).

One ``torch.save`` file holds the step count and the state dicts of the
processor, the classifier, the optimizer and the scheduler. It cannot
read the JAX package's orbax checkpoints; weights from there come across
through ``raw2logit_tpu_torch.convert``.
"""

import os

import torch


def save_state(state, path):
    """Write ``state`` to ``path`` (parent directories are made)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({
        "step": state.step,
        "processor": (None if state.processor is None
                      else state.processor.state_dict()),
        "classifier": state.classifier.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": (None if state.scheduler is None
                      else state.scheduler.state_dict()),
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
    if state.processor is not None:
        state.processor.load_state_dict(ckpt["processor"])
    state.classifier.load_state_dict(ckpt["classifier"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    if state.scheduler is not None:
        state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = ckpt["step"]
    return state
