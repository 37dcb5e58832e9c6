"""Data-parallel training over torch process groups, and the spatial and
pipeline axes of full-frame processing (port of
``raw2logit_tpu/parallel/``)."""

from raw2logit_tpu_torch.parallel import distributed  # noqa: F401
from raw2logit_tpu_torch.parallel.mesh import make_mesh, shard_batch
from raw2logit_tpu_torch.parallel.pipelines import process_pipeline_grid
from raw2logit_tpu_torch.parallel.spatial import process_full_frames

__all__ = ["distributed", "make_mesh", "shard_batch",
           "process_full_frames", "process_pipeline_grid"]
