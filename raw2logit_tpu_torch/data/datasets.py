"""Dataset constants, image loading, the synthetic offline datasets and
``Subset`` (port of the parts of ``raw2logit_tpu/data/datasets.py`` that
serving and the training CLI use). Datasets return (H, W) float32
numpy mosaics; all processing happens on the device.
"""

import os

import numpy as np

IMAGE_FILE_TYPES = ("dng", "png", "tif", "tiff")

# Camera calibration constants: (black_level[4 RGGB sites],
# white_balance[3], colour_matrix[9 row-major 3x3]).
DRONE_CAMERA_PARAMS = (
    [0.0625, 0.0626, 0.0625, 0.0626],
    [2.86653646, 1.0, 1.73079425],
    [1.50768983, -0.33571374, -0.17197604,
     -0.23048614, 1.70698738, -0.47650126,
     -0.03119153, -0.32803956, 1.35923111],
)
MICROSCOPY_CAMERA_PARAMS = (
    [9.834368023181512e-06] * 4,
    [-0.6567, 1.9673, 3.5304],
    [-2.0338, 0.0933, 0.4157,
     -0.0286, 2.6464, -0.0574,
     -0.5516, -0.0947, 2.9308],
)

# Per-dataset normalisation statistics (rgb, and mosaic for microscopy).
DATASET_STATS = {
    "Microscopy": {
        "mean": [0.91, 0.84, 0.94],
        "std": [0.08, 0.12, 0.05],
        "mosaic_mean": [0.5663, 0.1401, 0.0731],
        "mosaic_std": [0.097, 0.0423, 0.008],
    },
    "Drone": {
        "mean": [0.35, 0.36, 0.35],
        "std": [0.12, 0.11, 0.12],
    },
    "DroneSegmentation": {
        "mean": [0.35, 0.36, 0.35],
        "std": [0.12, 0.11, 0.12],
    },
}


def dataset_stats(name):
    """The RGB normalisation statistics of a dataset name: a synthetic set
    takes its real counterpart's, an unknown name Microscopy's."""
    return (DATASET_STATS.get(name.replace("Synthetic", ""))
            or DATASET_STATS["Microscopy"])


def load_image(path):
    """Decode one image to a float32 numpy array (values NOT normalised).

    dng -> the built-in pure-numpy CFA reader (``data/dng.py``); other
    types -> PIL, imported only here."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "dng":
        from raw2logit_tpu_torch.data.dng import read_dng
        return np.asarray(read_dng(path), np.float32)
    from PIL import Image
    return np.asarray(Image.open(path), np.float32)


def list_images_in_dir(path):
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.rsplit(".", 1)[-1].lower() in IMAGE_FILE_TYPES]


class Subset:
    """View of a dataset through an index list; other attributes (task,
    classes, camera_parameters) are the wrapped dataset's."""

    def __init__(self, dataset, indices=None):
        self.dataset = dataset
        self.indices = (list(indices) if indices is not None
                        else list(range(len(dataset))))

    def __len__(self):
        return len(self.indices)

    def __repr__(self):
        return f"Subset[{len(self)}] of {self.dataset!r}"

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __getattr__(self, name):
        if name in ("dataset", "indices"):  # not yet set while unpickling
            raise AttributeError(name)
        return getattr(self.dataset, name)


class _SyntheticRaw:
    """Deterministic synthetic Bayer mosaics with class-dependent structure
    (offline stand-ins for the real datasets)."""

    def __init__(self, n, h, w, seed, camera_parameters):
        self.n, self.h, self.w, self.seed = n, h, w, seed
        self.camera_parameters = camera_parameters

    def __len__(self):
        return self.n

    def _mosaic(self, idx):
        rng = np.random.default_rng((self.seed, idx))
        base = rng.uniform(0.1, 0.8, size=(self.h, self.w))
        yy, xx = np.mgrid[: self.h, : self.w]
        return base, rng, yy, xx


class SyntheticRawClassification(_SyntheticRaw):
    task = "classification"
    classes = ["dark_blob", "bright_blob"]

    def __init__(self, n=64, h=256, w=256, seed=0,
                 camera_parameters=MICROSCOPY_CAMERA_PARAMS):
        super().__init__(n, h, w, seed, camera_parameters)
        self.labels = [i % 2 for i in range(n)]
        self.images = [f"synthetic_{i}" for i in range(n)]

    def __getitem__(self, idx):
        base, rng, yy, xx = self._mosaic(idx)
        label = self.labels[idx]
        cy, cx = rng.uniform(0.3, 0.7, 2) * (self.h, self.w)
        r2 = ((yy - cy) ** 2 + (xx - cx) ** 2) / (0.15 * self.h) ** 2
        blob = np.exp(-r2)
        img = base + (0.18 if label else -0.18) * blob
        return np.clip(img, 0.0, 1.0).astype(np.float32), label


class SyntheticRawSegmentation(_SyntheticRaw):
    task = "segmentation"

    def __init__(self, n=32, h=256, w=256, seed=0,
                 camera_parameters=DRONE_CAMERA_PARAMS):
        super().__init__(n, h, w, seed, camera_parameters)
        self.images = [f"synthetic_{i}" for i in range(n)]
        self.masks = [f"synthetic_mask_{i}" for i in range(n)]

    def __getitem__(self, idx):
        base, rng, yy, xx = self._mosaic(idx)
        cy, cx = rng.uniform(0.25, 0.75, 2) * (self.h, self.w)
        ry, rx = rng.uniform(0.08, 0.2, 2) * (self.h, self.w)
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0)
        img = np.clip(base + 0.25 * mask, 0.0, 1.0)
        return img.astype(np.float32), mask.astype(np.float32)


def get_dataset(name, **kwargs):
    """Name -> synthetic dataset. The folder datasets (Microscopy, Drone)
    are not ported yet."""
    if name == "SyntheticMicroscopy":
        return SyntheticRawClassification(**kwargs)
    if name == "SyntheticDrone":
        return SyntheticRawSegmentation(**kwargs)
    raise ValueError(f"unknown or not yet ported dataset {name!r}")
