"""Experiment tracking: the local run store."""

from raw2logit_tpu_torch.tracking.run import (  # noqa: F401
    Run, display_run_info, find_run, get_model_by_name, list_runs,
    start_run)
