"""Data: DNG I/O, camera constants, synthetic datasets, k-fold splits,
the batch loader."""

from raw2logit_tpu_torch.data.datasets import (  # noqa: F401
    DATASET_STATS, DRONE_CAMERA_PARAMS, IMAGE_FILE_TYPES,
    MICROSCOPY_CAMERA_PARAMS, Subset, SyntheticRawClassification,
    SyntheticRawSegmentation, get_dataset, list_images_in_dir, load_image)
from raw2logit_tpu_torch.data.dng import read_dng, write_dng  # noqa: F401
from raw2logit_tpu_torch.data.kfold import k_fold  # noqa: F401
from raw2logit_tpu_torch.data.loader import ArrayDataset, Loader  # noqa: F401
