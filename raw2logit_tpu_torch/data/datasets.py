"""Dataset layer: camera constants, image loading, the folder datasets
(Microscopy, Drone), the tiling builders, the synthetic offline stand-ins
and ``get_dataset`` (port of ``raw2logit_tpu/data/datasets.py``).

Datasets return (H, W) float32 numpy mosaics in [0, 1]; all processing
happens on the device. DNGs decode with the built-in reader
(``data/dng.py``); TIFF and PNG files need PIL, which is imported only
where such a file is decoded or written, and whose absence raises (the
port reads DNGs and tile stores without it). The tile manifest of
``DroneDatasetClassificationTiled`` is read and written with the ``csv``
module, byte for byte as the JAX package's pandas writes it.
"""

import csv
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

_VALID_I_RATIOS = (0.01, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0)


def dataset_stats(name):
    """The RGB normalisation statistics of a dataset name: a synthetic set
    takes its real counterpart's, an unknown name Microscopy's."""
    return (DATASET_STATS.get(name.replace("Synthetic", ""))
            or DATASET_STATS["Microscopy"])


def pil_image(path):
    """PIL's ``Image`` module, to decode or write ``path``; raises an
    ImportError that names PIL where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: TIFF and PNG files need PIL (Pillow), which is not "
            "installed; a DNG (data/dng.py) or a tile store "
            "(data/tilestore.py) needs none") from e
    return Image


def load_image(path):
    """Decode one image to a float32 numpy array (values NOT normalised).

    dng -> the built-in pure-numpy CFA reader (``data/dng.py``); other
    types -> PIL (``pil_image``)."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "dng":
        from raw2logit_tpu_torch.data.dng import read_dng
        return np.asarray(read_dng(path), np.float32)
    return np.asarray(pil_image(path).open(path), np.float32)


def list_images_in_dir(path):
    return [os.path.join(path, f) for f in sorted(os.listdir(path))
            if f.rsplit(".", 1)[-1].lower() in IMAGE_FILE_TYPES]


def check_image_folder_consistency(images, masks):
    """Raise ValueError unless ``masks`` pair with ``images`` one to one,
    each mask's name holding its image's stem."""
    if len(images) != len(masks):
        raise ValueError("images / masks length mismatch")
    for img_file, mask_file in zip(images, masks):
        stem = os.path.basename(img_file).rsplit(".", 1)[0]
        if stem not in os.path.basename(mask_file):
            raise ValueError(f"image {img_file} corresponds to {mask_file}?")


# ---------------------------------------------------------------------------
# generic folder datasets


class FolderClassification:
    """Images in a folder + integer labels -> (HW float32 in [0,1], int)."""

    task = "classification"

    def __init__(self, images, labels, bits=16):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} "
                             "labels")
        self.images = list(images)
        self.labels = list(labels)
        self.bits = bits

    def __len__(self):
        return len(self.images)

    def __repr__(self):
        return f"{type(self).__name__}[{len(self)}]"

    def __getitem__(self, idx):
        img = load_image(self.images[idx]) / (2 ** self.bits - 1)
        return np.asarray(img, np.float32), self.labels[idx]


class FolderSegmentation:
    """Image + mask folders -> (HW float32 in [0,1], HW {0,1} float32)."""

    task = "segmentation"

    def __init__(self, img_dir, mask_dir, bits=16):
        self.img_dir = img_dir
        self.mask_dir = mask_dir
        self.images = list_images_in_dir(img_dir)
        self.masks = list_images_in_dir(mask_dir)
        check_image_folder_consistency(self.images, self.masks)
        self.bits = bits

    def __len__(self):
        return len(self.images)

    def __repr__(self):
        return f"{type(self).__name__}[{len(self)}]"

    def __getitem__(self, idx):
        img = load_image(self.images[idx]) / (2 ** self.bits - 1)
        mask = (load_image(self.masks[idx]) > 0).astype(np.float32)
        return np.asarray(img, np.float32), mask


class Subset:
    """View of a dataset through an index list; other attributes (task,
    classes, camera_parameters) are the wrapped dataset's. A view of a
    tile store has ``gather`` through the index list; a view of any other
    dataset has none."""

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
        if name == "gather":
            # batched reads go through the index list: forwarded as it is,
            # the store would read the subset's positions as its own rows
            base_gather = getattr(self.dataset, "gather")
            indices = self.indices
            return lambda idx: base_gather([indices[int(i)] for i in idx])
        return getattr(self.dataset, name)


class MultiIntensity:
    """Same-layout datasets of different exposure intensities, one after
    the other."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        base = self.datasets[0]
        self.task = base.task
        self.classes = getattr(base, "classes", None)
        self.camera_parameters = getattr(base, "camera_parameters", None)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, idx):
        d = int(np.searchsorted(self._offsets, idx, side="right")) - 1
        return self.datasets[d][idx - int(self._offsets[d])]


# ---------------------------------------------------------------------------
# drone (aerial car segmentation / binary classification)


def _scale_dir(I_ratio):
    if I_ratio not in _VALID_I_RATIOS:
        raise ValueError(f"I_ratio {I_ratio} not in {_VALID_I_RATIOS}")
    return f"raw_scale{int(I_ratio * 100):03d}"


class DroneDatasetSegmentationFull(FolderSegmentation):
    """Full-frame drone raws + masks; fetched when the folder is
    missing."""

    camera_parameters = DRONE_CAMERA_PARAMS

    def __init__(self, I_ratio=1.0, data_root="data", bits=16,
                 force_download=False):
        img_dir = os.path.join(data_root, "drone", "images_full",
                               _scale_dir(I_ratio))
        mask_dir = os.path.join(data_root, "drone", "masks_full")
        if force_download or not os.path.isdir(img_dir):
            from raw2logit_tpu_torch.data.download import \
                download_drone_dataset
            download_drone_dataset(data_root=data_root,
                                   force_download=force_download)
        super().__init__(img_dir=img_dir, mask_dir=mask_dir, bits=bits)


class DroneDatasetSegmentationTiled(FolderSegmentation):
    """Tiles of the full frames, car-free tiles dropped; tiled on first
    use."""

    camera_parameters = DRONE_CAMERA_PARAMS

    def __init__(self, I_ratio=1.0, data_root="data", tile_size=256):
        img_dir = os.path.join(data_root, "drone",
                               f"images_tiles_{tile_size}",
                               _scale_dir(I_ratio))
        mask_dir = os.path.join(data_root, "drone",
                                f"masks_tiles_{tile_size}")
        if not os.path.isdir(img_dir) or not os.path.isdir(mask_dir):
            from raw2logit_tpu_torch.data.tiling import create_tiles_dataset
            full = DroneDatasetSegmentationFull(I_ratio=I_ratio,
                                                data_root=data_root)
            print("tiling dataset..")
            create_tiles_dataset(full, img_dir, mask_dir,
                                 tile_size=tile_size)
        super().__init__(img_dir=img_dir, mask_dir=mask_dir, bits=16)


class DroneDatasetClassificationTiled(FolderClassification):
    """Balanced binary car/no-car tiles and their CSV manifest, built on
    first use. ``df`` holds the manifest's columns, {"file name": [...],
    "label": [...]}."""

    camera_parameters = DRONE_CAMERA_PARAMS

    def __init__(self, I_ratio=1.0, data_root="data", tile_size=256,
                 random_state=72, thr=0.01):
        base = os.path.join(data_root, "drone", "classification")
        img_dir = os.path.join(base, f"images_tiles_{tile_size}",
                               f"{_scale_dir(I_ratio)}_thr_{thr}")
        mask_dir = os.path.join(base, f"masks_tiles_{tile_size}",
                                f"{_scale_dir(I_ratio)}_thr_{thr}")
        df_path = os.path.join(
            base, f"dataset_tiles_{tile_size}_{random_state}_{thr}.csv")
        if not os.path.isdir(img_dir) or not os.path.exists(df_path):
            full = DroneDatasetSegmentationFull(I_ratio=I_ratio,
                                                data_root=data_root)
            print("tiling dataset..")
            create_tiles_dataset_binary(full, img_dir, mask_dir,
                                        random_state=random_state, thr=thr,
                                        tile_size=tile_size,
                                        data_root=data_root)
        self.classes = ["car", "no car"]
        self.df = read_manifest(df_path)
        images, labels = read_label_csv(self.df)
        images = [os.path.join(img_dir, name) for name in images]
        super().__init__(images=images, labels=labels, bits=16)
        self.img_dir = img_dir


def write_manifest(path, ids, labels):
    """Write the tile manifest: a ``file name,label`` header, then one row
    per tile, as pandas' ``DataFrame.to_csv(index=False)`` writes it."""
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator=os.linesep)
        writer.writerow(("file name", "label"))
        writer.writerows(zip(ids, labels))


def read_manifest(path):
    """The tile manifest's columns: {"file name": [str], "label": [int]}."""
    with open(path, newline="") as fh:
        rows = list(csv.DictReader(fh))
    return {"file name": [r["file name"] for r in rows],
            "label": [int(r["label"]) for r in rows]}


def read_label_csv(df):
    """Manifest columns (``read_manifest``'s dict, or a DataFrame) ->
    (tile file names with .tif, int labels)."""
    images = [f"{name}.tif" for name in df["file name"]]
    labels = [int(v) for v in df["label"]]
    return images, labels


def binary_class_detection(X, Y, random_seed, thr):
    """Split tiles into balanced with-class / without-class sets by mask
    mean; tiles with 0 < mean <= thr are ambiguous and discarded, and the
    larger side is subsampled to the smaller with a seeded shuffle."""
    means = np.asarray([float(m.mean()) for m in Y])
    with_idx = np.flatnonzero(means > thr)
    without_idx = np.flatnonzero(means == 0)
    rng = np.random.default_rng(random_seed)
    n = min(len(with_idx), len(without_idx))
    if len(with_idx) > n:
        with_idx = rng.permutation(with_idx)[:n]
    if len(without_idx) > n:
        without_idx = rng.permutation(without_idx)[:n]
    return (X[with_idx], X[without_idx], Y[with_idx], Y[without_idx])


def create_tiles_dataset_binary(dataset, img_dir, mask_dir, random_state,
                                thr, tile_size=256, data_root="data"):
    """Tile, balance and write the binary-classification dataset and its
    CSV manifest. Label 0 = car, 1 = no car. Writes TIFF and PNG, so it
    needs PIL."""
    from raw2logit_tpu_torch.data.tiling import _save_tile, split_img
    Image = pil_image(img_dir)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)

    ids, labels = [], []
    for n in range(len(dataset)):
        img, mask = dataset[n]
        tiles = split_img(np.asarray(img), ROIs=(tile_size, tile_size),
                          step=(tile_size, tile_size))
        mtiles = split_img(np.asarray(mask), ROIs=(tile_size, tile_size),
                           step=(tile_size, tile_size))
        x_w, x_wo, y_w, y_wo = binary_class_detection(tiles, mtiles,
                                                      random_state, thr)
        i = -1
        for i, (t, mt) in enumerate(zip(x_w, y_w)):
            tile_id = f"{n:02d}_{i:05d}"
            ids.append(tile_id)
            labels.append(0)
            _save_tile(t, os.path.join(img_dir, tile_id + ".tif"))
            Image.fromarray(mt > 0).save(
                os.path.join(mask_dir, tile_id + ".png"))
        for j, (t, mt) in enumerate(zip(x_wo, y_wo)):
            tile_id = f"{n:02d}_{i + 1 + j:05d}"
            ids.append(tile_id)
            labels.append(1)
            _save_tile(t, os.path.join(img_dir, tile_id + ".tif"))
            Image.fromarray(mt > 0).save(
                os.path.join(mask_dir, tile_id + ".png"))

    base = os.path.join(data_root, "drone", "classification")
    os.makedirs(base, exist_ok=True)
    write_manifest(os.path.join(
        base, f"dataset_tiles_{tile_size}_{random_state}_{thr}.csv"),
        ids, labels)


# ---------------------------------------------------------------------------
# microscopy (leukocyte classification)


def read_label_file(label_file_path):
    """Parse Ma190c_annotations.dat: '<stem> <CLASS>' per line ->
    (['<stem>.tiff', ...], ['CLASS', ...])."""
    images, class_labels = [], []
    with open(label_file_path, "rb") as fh:
        for line in fh:
            parts = line.decode("utf-8").split()
            if len(parts) != 2:
                continue
            images.append(parts[0] + ".tiff")
            class_labels.append(parts[1])
    return images, class_labels


class MicroscopyDataset(FolderClassification):
    """Raw 16-bit microscopy tiffs labelled by the annotations file;
    classes with <= 4 examples filtered, known-invalid files dropped;
    fetched when the label file or the image folder is missing."""

    camera_parameters = MICROSCOPY_CAMERA_PARAMS
    valid_classes = ["BAS", "EBO", "EOS", "KSC", "LYA", "LYT", "MMZ", "MOB",
                     "MON", "MYB", "MYO", "NGB", "NGS", "PMB", "PMO", "UNC"]
    invalid_files = ["Ma190c_lame3_zone13_composite_Mcropped_2.tiff"]
    _scale_prefix = "raw_scale"  # MicroscopyDatasetRGB reads rgb_scale*

    def __init__(self, I_ratio=1.0, data_root="data", bits=16,
                 force_download=False):
        img_dir = os.path.join(
            data_root, "microscopy", "images",
            _scale_dir(I_ratio).replace("raw_scale", self._scale_prefix))
        label_file = os.path.join(data_root, "microscopy", "labels",
                                  "Ma190c_annotations.dat")
        if (force_download or not os.path.exists(label_file)
                or not os.path.isdir(img_dir)):
            from raw2logit_tpu_torch.data.download import \
                download_microscopy_dataset
            download_microscopy_dataset(data_root=data_root,
                                        force_download=force_download)

        images, class_labels = read_label_file(label_file)
        # classes are counted over the whole label file, before the
        # invalid files leave
        keep_classes = [c for c in self.valid_classes
                        if class_labels.count(c) > 4]
        pairs = [(img, c) for img, c in zip(images, class_labels)
                 if c in keep_classes and img not in self.invalid_files]
        images, class_labels = zip(*pairs) if pairs else ((), ())
        self.classes = sorted(set(class_labels))
        super().__init__(
            images=[os.path.join(img_dir, img) for img in images],
            labels=[self.classes.index(c) for c in class_labels],
            bits=bits)
        self.img_dir = img_dir


class MicroscopyDatasetRGB(MicroscopyDataset):
    """RGB variant: same labels, images under rgb_scale*."""

    camera_parameters = None
    _scale_prefix = "rgb_scale"


# ---------------------------------------------------------------------------
# synthetic offline stand-ins (no network; deterministic per index)


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


# ---------------------------------------------------------------------------


def get_dataset(name, I_ratio=1.0, **kwargs):
    """Name -> dataset: the folder datasets under their aliases (each
    reading ``data_root``, default ``data``, at exposure ``I_ratio``) and
    the synthetic offline stand-ins (which take no ``I_ratio``)."""
    if name in ("DC", "Drone", "DroneClassification",
                "DroneDatasetClassificationTiled"):
        return DroneDatasetClassificationTiled(I_ratio=I_ratio, **kwargs)
    if name in ("DS", "DroneSegmentation", "DroneDatasetSegmentationTiled"):
        return DroneDatasetSegmentationTiled(I_ratio=I_ratio, **kwargs)
    if name in ("M", "Microscopy", "MicroscopyDataset"):
        return MicroscopyDataset(I_ratio=I_ratio, **kwargs)
    if name in ("DSF", "DroneDatasetSegmentationFull"):
        return DroneDatasetSegmentationFull(I_ratio=I_ratio, **kwargs)
    if name in ("MRGB", "MicroscopyRGB", "MicroscopyDatasetRGB"):
        return MicroscopyDatasetRGB(I_ratio=I_ratio, **kwargs)
    if name == "SyntheticMicroscopy":
        return SyntheticRawClassification(**kwargs)
    if name == "SyntheticDrone":
        return SyntheticRawSegmentation(**kwargs)
    raise ValueError(name)
