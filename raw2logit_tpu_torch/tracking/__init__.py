"""Experiment tracking: the local run store."""

from raw2logit_tpu_torch.tracking.run import Run  # noqa: F401
