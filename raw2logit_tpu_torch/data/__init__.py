"""Data: DNG I/O, camera constants, the folder and synthetic datasets,
tiling, the tile store, k-fold splits, the batch loader, the static-ISP
precompute. The tile store (``data/tilestore.py``) and the download
(``data/download.py``) are imported from their modules: the store builds
its C++ library at first use."""

from raw2logit_tpu_torch.data.datasets import (  # noqa: F401
    DATASET_STATS, DRONE_CAMERA_PARAMS, IMAGE_FILE_TYPES,
    MICROSCOPY_CAMERA_PARAMS, DroneDatasetClassificationTiled,
    DroneDatasetSegmentationFull, DroneDatasetSegmentationTiled,
    FolderClassification, FolderSegmentation, MicroscopyDataset,
    MicroscopyDatasetRGB, MultiIntensity, Subset, SyntheticRawClassification,
    SyntheticRawSegmentation, binary_class_detection,
    check_image_folder_consistency, create_tiles_dataset_binary,
    dataset_stats, get_dataset, list_images_in_dir, load_image,
    read_label_csv, read_label_file, read_manifest, write_manifest)
from raw2logit_tpu_torch.data.dng import read_dng, write_dng  # noqa: F401
from raw2logit_tpu_torch.data.kfold import k_fold  # noqa: F401
from raw2logit_tpu_torch.data.loader import (  # noqa: F401
    ArrayDataset, Loader, make_dataloader)
from raw2logit_tpu_torch.data.precompute import (  # noqa: F401
    PrecomputedRGBView, precompute_pipeline_rgb)
from raw2logit_tpu_torch.data.tiling import (  # noqa: F401
    create_tiles_dataset, join_blocks, one2many_random_ROI, random_ROI,
    split_img)
