"""Shared host utilities (port of ``raw2logit_tpu/utils/__init__.py``):
layout conversion, names, seeding, normalisation, dataset statistics and
the balanced drone split.

The JAX package's ``enable_compilation_cache`` sets up XLA's persistent
compilation cache and has no counterpart: the port compiles no programs,
and its CUDA libraries are cached by content hash under ``build/``.
"""

import random

import numpy as np
import torch


def chw_to_hwc(x):
    """(B, C, H, W) / (C, H, W) arrays -> channels last."""
    x = np.asarray(x)
    if x.ndim == 4:
        return np.transpose(x, (0, 2, 3, 1))
    if x.ndim == 3 and x.shape[0] <= 4:
        return np.transpose(x, (1, 2, 0))
    return x


def hwc_to_chw(x):
    """(B, H, W, C) / (H, W, C) arrays -> channels first."""
    x = np.asarray(x)
    if x.ndim == 4:
        return np.transpose(x, (0, 3, 1, 2))
    if x.ndim == 3 and x.shape[-1] <= 4:
        return np.transpose(x, (2, 0, 1))
    return x


def get_name(obj):
    """Readable name of a function, class or instance."""
    return obj.__name__ if hasattr(obj, "__name__") else type(obj).__name__


def set_random_seed(seed):
    """Seed numpy's global generator, ``random`` and torch (every device's
    default generator)."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def normalize(img):
    """Per-channel standardisation of an HWC (or HW) image: (img, mu,
    sigma)."""
    img = np.asarray(img, float)
    if img.ndim == 2:
        img = img[:, :, None]
    mu = img.mean(axis=(0, 1))
    sigma = img.std(axis=(0, 1))
    return (img - mu) / (sigma + 1e-4), mu, sigma


def data_loader_mean_and_std(data_loader, transform=None):
    """Per-channel mean and std averaged over a loader's batches.

    Each batch's per-channel mean and std (ddof=1, as ``torch.std``), then
    their average across batches: not a pooled estimate, a small last
    batch weighs as much as a full one. Batches are NHWC (or NHW
    grayscale) arrays or tensors; returns two (C,) float32 arrays.
    """
    means, stds = [], []
    for x, _y in data_loader:
        x = np.asarray(x, np.float64)
        if transform is not None:
            x = np.asarray(transform(x), np.float64)
        if x.ndim == 3:  # NHW grayscale -> one channel
            x = x[..., None]
        means.append(x.mean(axis=(0, 1, 2)))
        stds.append(x.std(axis=(0, 1, 2), ddof=1))
    return (np.stack(means).mean(axis=0).astype(np.float32),
            np.stack(stds).mean(axis=0).astype(np.float32))


def get_statistics(dataset, train_indices, transform=None):
    """Mean and std (ddof=1) of a dataset's subset as one batch: (H, W)
    items reduce to scalars, (H, W, C) items per channel. Returns float32
    arrays of shape () or (C,)."""
    imgs = []
    for i in train_indices:
        x = np.asarray(dataset[int(i)][0], np.float64)
        if transform is not None:
            x = np.asarray(transform(x), np.float64)
        imgs.append(x)
    batch = np.stack(imgs)
    if batch.ndim == 3:  # (N, H, W) grayscale mosaics -> scalar stats
        return (batch.mean().astype(np.float32),
                batch.std(ddof=1).astype(np.float32))
    return (batch.mean(axis=(0, 1, 2)).astype(np.float32),
            batch.std(axis=(0, 1, 2), ddof=1).astype(np.float32))


def get_train_test_indices_drone(df, frac, seed=None):
    """Balanced binary train/test split of a labelled table.

    ``df`` has a ``label`` column of 0s and 1s: a pandas DataFrame, whose
    index values are returned, or a mapping of columns (``read_manifest``'s
    dict), whose row positions are. ``int(len(df) * frac / 2)`` rows of
    each label go to the train side, drawn as pandas'
    ``sample(n, random_state=seed)`` draws them; the rest form the test
    side. Each side lists its label-0 rows, then its label-1 rows.
    ``seed=None`` reseeds numpy's global generator from the system's
    entropy, as the JAX package does. Returns two lists of row keys."""
    labels = np.asarray(df["label"])
    keys = list(df.index) if hasattr(df, "index") else list(
        range(len(labels)))
    split_idx = int(len(labels) * frac / 2)
    with_keys = [k for k, v in zip(keys, labels) if v == 1]
    without_keys = [k for k, v in zip(keys, labels) if v == 0]

    np.random.seed(seed)

    def sample(rows):
        # pandas' sample: RandomState(seed).choice(len, n, replace=False)
        # (the global generator for seed None), in the order drawn
        rs = (np.random.RandomState(seed) if seed is not None
              else np.random.mtrand._rand)
        picked = [rows[i] for i in rs.choice(len(rows), size=split_idx,
                                             replace=False)]
        chosen = set(picked)
        return picked, [k for k in rows if k not in chosen]

    with_train, with_test = sample(with_keys)
    without_train, without_test = sample(without_keys)
    return without_train + with_train, without_test + with_test
