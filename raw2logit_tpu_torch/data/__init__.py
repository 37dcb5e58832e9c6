"""Data: DNG I/O, camera constants, synthetic datasets, k-fold splits,
the batch loader, the static-ISP precompute."""

from raw2logit_tpu_torch.data.datasets import (  # noqa: F401
    DATASET_STATS, DRONE_CAMERA_PARAMS, IMAGE_FILE_TYPES,
    MICROSCOPY_CAMERA_PARAMS, Subset, SyntheticRawClassification,
    SyntheticRawSegmentation, dataset_stats, get_dataset, list_images_in_dir,
    load_image)
from raw2logit_tpu_torch.data.dng import read_dng, write_dng  # noqa: F401
from raw2logit_tpu_torch.data.kfold import k_fold  # noqa: F401
from raw2logit_tpu_torch.data.loader import ArrayDataset, Loader  # noqa: F401
from raw2logit_tpu_torch.data.precompute import (  # noqa: F401
    PrecomputedRGBView, precompute_pipeline_rgb)
