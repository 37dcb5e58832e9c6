"""Experiment tracking: the local run store and its image grids."""

from raw2logit_tpu_torch.tracking.run import (  # noqa: F401
    Run, display_run_info, find_run, get_model_by_name, list_runs,
    start_run)
from raw2logit_tpu_torch.tracking.images import save_image_grid  # noqa: F401
