"""Training: configuration, state, train and eval steps, checkpoints; the
CLI is ``raw2logit_tpu_torch.training.train``."""

from raw2logit_tpu_torch.training.core import (  # noqa: F401
    TrainConfig, TrainState, create_train_state, make_eval_step,
    make_train_step)

__all__ = ["TrainConfig", "TrainState", "create_train_state",
           "make_train_step", "make_eval_step"]
