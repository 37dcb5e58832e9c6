"""Training: configuration, state, optimizer forms, the train steps (one
step and staged), the eval step, checkpoints; the CLI is
``raw2logit_tpu_torch.training.train``."""

from raw2logit_tpu_torch.training.core import (  # noqa: F401
    TrainConfig, TrainState, create_train_state, make_eval_step,
    make_optimizer, make_staged_train_step, make_train_step)

__all__ = ["TrainConfig", "TrainState", "create_train_state",
           "make_optimizer", "make_train_step", "make_staged_train_step",
           "make_eval_step"]
