"""Experiment tracking: the local run store, and the tracked stages and
image grids."""

from raw2logit_tpu_torch.tracking.run import (  # noqa: F401
    Run, display_run_info, find_run, get_model_by_name, list_runs,
    start_run)
from raw2logit_tpu_torch.tracking.images import (  # noqa: F401
    log_tensor, save_image_grid, stage_gradients, track_images)
