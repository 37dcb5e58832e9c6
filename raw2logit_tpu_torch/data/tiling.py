"""Host-side spatial tiling: full frames -> fixed tiles, and reassembly
(port of ``raw2logit_tpu/data/tiling.py``; numpy only).

Tiling fixes the device-side shapes: full drone frames are cut once into
tiles at dataset-build time, and every step then sees one shape.
"""

import os

import numpy as np

from raw2logit_tpu_torch.data.datasets import pil_image


def split_img(imgs, ROIs=(3, 3), step=(1, 1)):
    """Split image(s) into (possibly overlapping) ROI windows.

    Shapes accepted:
      (H, W)          -> (N, rh, rw)
      (H, W, C<=3)    -> (N, rh, rw, C)    one image, channels last
      (B, H, W) [C>3] -> (N, rh, rw)       stack of one-channel images
      (B, H, W, C)    -> (N, rh, rw, C)
    """
    imgs = np.asarray(imgs)
    rh, rw = ROIs
    sh, sw = step

    def windows2d(a):
        v = np.lib.stride_tricks.sliding_window_view(a, (rh, rw),
                                                     axis=(0, 1))
        return v[::sh, ::sw]

    if imgs.ndim == 2:
        return windows2d(imgs).reshape(-1, rh, rw)
    if imgs.ndim == 3:
        if imgs.shape[-1] <= 3:  # one HWC image
            # the windows come as (nh, nw, C, rh, rw): channels last again
            return np.moveaxis(windows2d(imgs), 2, -1).reshape(
                -1, rh, rw, imgs.shape[-1])
        out = [windows2d(im).reshape(-1, rh, rw) for im in imgs]
        return np.concatenate(out, axis=0)
    if imgs.ndim == 4:
        out = [np.moveaxis(windows2d(im), 2, -1).reshape(
            -1, rh, rw, im.shape[-1]) for im in imgs]
        return np.concatenate(out, axis=0)
    raise ValueError(f"unsupported ndim {imgs.ndim}")


def join_blocks(blocks, final_shape):
    """Reassemble non-overlapping blocks (N, C, rh, rw) -> (C, H, W)."""
    blocks = np.asarray(blocks)
    n, c, rh, rw = blocks.shape
    rows = final_shape[0] // rh
    cols = final_shape[1] // rw
    grid = blocks[: rows * cols].reshape(rows, cols, c, rh, rw)
    # (rows, cols, c, rh, rw) -> (c, rows*rh, cols*rw)
    return grid.transpose(2, 0, 3, 1, 4).reshape(c, rows * rh, cols * rw)


def random_ROI(X, Y, ROIs=(512, 512), rng=None):
    """One random crop per (input, target) pair; NHWC in, NHWC out."""
    rng = rng or np.random.default_rng()
    b, h, w, c = X.shape
    X_cut = np.empty((b, ROIs[0], ROIs[1], c), X.dtype)
    Y_cut = np.empty((b, ROIs[0], ROIs[1], Y.shape[-1]), Y.dtype)
    for i in range(b):
        y0 = int(rng.integers(0, max(h - ROIs[0], 0) + 1))
        x0 = int(rng.integers(0, max(w - ROIs[1], 0) + 1))
        X_cut[i] = X[i, y0:y0 + ROIs[0], x0:x0 + ROIs[1]]
        Y_cut[i] = Y[i, y0:y0 + ROIs[0], x0:x0 + ROIs[1]]
    return X_cut, Y_cut


def one2many_random_ROI(X, Y, datasize=1000, ROIs=(512, 512), rng=None):
    """``datasize`` random crops of the same image."""
    rng = rng or np.random.default_rng()
    Xs, Ys = [], []
    for _ in range(datasize):
        xc, yc = random_ROI(X, Y, ROIs, rng)
        Xs.append(xc[0])
        Ys.append(yc[0])
    return np.stack(Xs), np.stack(Ys)


def _save_tile(arr, path):
    """Write a tile as a TIFF (float tiles as uint16 counts); needs PIL."""
    Image = pil_image(path)
    arr = np.asarray(arr)
    if arr.dtype.kind == "f":
        arr = (np.clip(arr, 0.0, 1.0) * 65535.0).round().astype(np.uint16)
    Image.fromarray(arr).save(path)


def keeps_tile(mask_tile):
    """Whether ``create_tiles_dataset`` keeps a tile: its mask is not
    empty."""
    return mask_tile.mean() != 0


def create_tiles_dataset(dataset, img_dir, mask_dir, tile_size=256):
    """Tile a full-frame segmentation dataset onto disk, keeping only tiles
    whose mask is non-empty. Images -> <img_dir>/<frame>_<tile>.tif
    (uint16), masks -> <mask_dir>/<frame>_<tile>.png (binary); needs
    PIL."""
    Image = pil_image(img_dir)
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    for n in range(len(dataset)):
        img, mask = dataset[n]
        tiles = split_img(np.asarray(img), ROIs=(tile_size, tile_size),
                          step=(tile_size, tile_size))
        mtiles = split_img(np.asarray(mask), ROIs=(tile_size, tile_size),
                           step=(tile_size, tile_size))
        kept = 0
        for t, mt in zip(tiles, mtiles):
            if not keeps_tile(mt):
                continue
            tile_id = f"{n:02d}_{kept:05d}"
            _save_tile(t, os.path.join(img_dir, tile_id + ".tif"))
            Image.fromarray(mt > 0).save(
                os.path.join(mask_dir, tile_id + ".png"))
            kept += 1
