"""The port's host utilities (``raw2logit_tpu_torch/utils.py``) on the cases
of tests/test_utils.py, and held to the JAX package's values on the same
seeded inputs; with the port's ``make_dataloader`` and
``read_label_csv``."""

import random

import numpy as np
import pandas as pd
import pytest
import torch

from raw2logit_tpu import utils as jutils

from raw2logit_tpu_torch import utils
from raw2logit_tpu_torch.data import make_dataloader, read_manifest
from raw2logit_tpu_torch.data import write_manifest
from raw2logit_tpu_torch.data.datasets import read_label_csv
from raw2logit_tpu_torch.utils import (chw_to_hwc, data_loader_mean_and_std,
                                       get_name, get_statistics,
                                       get_train_test_indices_drone,
                                       hwc_to_chw, normalize)


def test_chw_hwc_roundtrip():
    x = np.random.default_rng(0).uniform(size=(2, 3, 8, 8)).astype(np.float32)
    assert chw_to_hwc(x).shape == (2, 8, 8, 3)
    np.testing.assert_array_equal(hwc_to_chw(chw_to_hwc(x)), x)


@pytest.mark.parametrize("shape", [(2, 3, 8, 8), (3, 8, 8), (8, 8, 3),
                                   (5, 8, 8), (8, 8)])
def test_layout_conversions_as_jax(shape):
    x = np.random.default_rng(1).uniform(size=shape)
    for name in ("chw_to_hwc", "hwc_to_chw"):
        got, want = getattr(utils, name)(x), getattr(jutils, name)(x)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_normalize_standardizes():
    img = np.random.default_rng(0).uniform(1, 5, (16, 16, 3))
    out, mu, sigma = normalize(img)
    assert np.allclose(out.mean(axis=(0, 1)), 0, atol=1e-2)
    np.testing.assert_allclose(mu, img.mean(axis=(0, 1)))


@pytest.mark.parametrize("shape", [(16, 16, 3), (9, 7)])
def test_normalize_as_jax(shape):
    img = np.random.default_rng(2).uniform(1, 5, shape).astype(np.float32)
    for got, want in zip(normalize(img), jutils.normalize(img)):
        assert np.array_equal(got, want)


def test_data_loader_mean_and_std_batch_averaged():
    """The mean of per-batch stats, with the ddof=1 std."""
    rng = np.random.default_rng(1)
    batches = [(rng.uniform(size=(4, 8, 8, 3)).astype(np.float32), None)
               for _ in range(3)]
    mean, std = data_loader_mean_and_std(batches)
    want_mean = np.mean([b.mean(axis=(0, 1, 2)) for b, _ in batches], axis=0)
    want_std = np.mean([b.std(axis=(0, 1, 2), ddof=1) for b, _ in batches],
                       axis=0)
    np.testing.assert_allclose(mean, want_mean, rtol=1e-6)
    np.testing.assert_allclose(std, want_std, rtol=1e-6)
    assert mean.shape == (3,)
    for got, want in zip((mean, std), jutils.data_loader_mean_and_std(
            batches)):
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_data_loader_mean_and_std_transform_and_grayscale():
    rng = np.random.default_rng(2)
    batches = [(rng.uniform(size=(4, 8, 8)).astype(np.float32), None)]
    mean, std = data_loader_mean_and_std(batches, transform=lambda x: x * 2)
    np.testing.assert_allclose(mean, 2 * batches[0][0].mean(), rtol=1e-6)
    assert mean.shape == (1,)
    want = jutils.data_loader_mean_and_std(batches, transform=lambda x: x * 2)
    assert np.array_equal(mean, want[0]) and np.array_equal(std, want[1])


def test_data_loader_mean_and_std_over_a_port_loader():
    """Tensors or arrays: the port's Loader over an array pair gives the
    statistics of the same batches."""
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(10, 6, 6, 3)).astype(np.float32)
    loader = make_dataloader((X, np.arange(10)), batch_size=4,
                             shuffle=False, prefetch=False)
    got = data_loader_mean_and_std(loader)
    want = jutils.data_loader_mean_and_std(
        [(X[i:i + 4], None) for i in range(0, 10, 4)])
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    tensors = [(torch.as_tensor(X[i:i + 4]), None) for i in range(0, 10, 4)]
    assert all(np.array_equal(g, w) for g, w in zip(
        data_loader_mean_and_std(tensors), want))


def test_get_statistics_per_channel_and_scalar():
    """Whole-subset single-pass stats; grayscale items reduce to scalars,
    HWC items per channel."""
    rng = np.random.default_rng(3)
    rgb = [(rng.uniform(size=(8, 8, 3)).astype(np.float32), 0)
           for _ in range(5)]
    mean, std = get_statistics(rgb, [0, 2, 4])
    stack = np.stack([rgb[i][0] for i in (0, 2, 4)]).astype(np.float64)
    np.testing.assert_allclose(mean, stack.mean(axis=(0, 1, 2)), rtol=1e-6)
    np.testing.assert_allclose(std, stack.std(axis=(0, 1, 2), ddof=1),
                               rtol=1e-6)
    for got, want in zip((mean, std), jutils.get_statistics(rgb, [0, 2, 4])):
        assert np.array_equal(got, want)

    gray = [(rng.uniform(size=(8, 8)).astype(np.float32), 0)
            for _ in range(4)]
    mean, std = get_statistics(gray, range(4))
    assert np.ndim(mean) == 0 and np.ndim(std) == 0
    np.testing.assert_allclose(
        float(mean), np.stack([g for g, _ in gray]).mean(), rtol=1e-6)
    want = jutils.get_statistics(gray, range(4))
    assert mean == want[0] and std == want[1]


def test_get_statistics_with_transform():
    data = [(np.full((4, 4, 3), i, np.float32), 0) for i in range(3)]
    mean, _ = get_statistics(data, [0, 1, 2], transform=lambda x: x + 1)
    np.testing.assert_allclose(mean, [2.0, 2.0, 2.0])


def test_get_train_test_indices_drone_balanced():
    """Seeded balanced split, label-0 block first, complements form the
    test side."""
    rng = np.random.default_rng(4)
    labels = np.array([0, 1] * 20)
    df = pd.DataFrame({"label": labels,
                       "x": rng.uniform(size=len(labels))})
    train, test = get_train_test_indices_drone(df, frac=0.5, seed=7)
    assert len(train) == 2 * int(len(df) * 0.5 / 2) == 20
    assert set(train).isdisjoint(test)
    assert sorted(train + test) == list(range(len(df)))
    assert sum(df.loc[i, "label"] for i in train) == len(train) // 2
    assert sum(df.loc[i, "label"] for i in test) == len(test) // 2
    train2, _ = get_train_test_indices_drone(df, frac=0.5, seed=7)
    assert train == train2
    train3, _ = get_train_test_indices_drone(df, frac=0.5, seed=8)
    assert train != train3


@pytest.mark.parametrize("seed,frac", [(7, 0.5), (0, 0.3), (72, 0.9),
                                       (3, 0.0)])
def test_get_train_test_indices_drone_as_jax(seed, frac, tmp_path):
    """pandas' sample draws, without pandas: on a DataFrame with an index
    of its own, and on the port's manifest columns (row positions)."""
    rng = np.random.default_rng(6)
    labels = rng.integers(0, 2, 37)
    df = pd.DataFrame({"label": labels}, index=np.arange(37) * 3 + 100)

    def both(table, as_jax):
        fn = (jutils if as_jax else utils).get_train_test_indices_drone
        return fn(table, frac, seed)
    got, want = both(df, False), both(df, True)
    assert got == want and len(got[0]) == 2 * int(37 * frac / 2)
    path = str(tmp_path / "m.csv")
    write_manifest(path, [f"00_{i:05d}" for i in range(37)], labels)
    got = both(read_manifest(path), False)
    want = both(df.reset_index(drop=True), True)
    assert got == want


def test_set_random_seed_seeds_numpy_random_and_torch():
    utils.set_random_seed(3)
    got = (np.random.rand(2), random.random(), torch.rand(2))
    jutils.set_random_seed(3)
    want = (np.random.rand(2), random.random())
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    torch.manual_seed(3)
    assert torch.equal(got[2], torch.rand(2))


def test_get_name():
    def my_fn():
        pass

    class Thing:
        pass

    for fn in (get_name, jutils.get_name):
        assert fn(my_fn) == "my_fn"
        assert fn(Thing) == "Thing"
        assert fn(Thing()) == "Thing"


def test_read_label_csv():
    """'file name'/'label' columns -> .tif names + int labels."""
    df = pd.DataFrame({"file name": ["00_00001", "00_00002"],
                       "label": ["1", 0]})
    images, labels = read_label_csv(df)
    assert images == ["00_00001.tif", "00_00002.tif"]
    assert labels == [1, 0]


def test_make_dataloader_over_array_pair():
    """(X, Y) arrays -> batch iterator, channels last as given."""
    X = np.arange(10 * 4 * 4 * 3, dtype=np.float32).reshape(10, 4, 4, 3)
    Y = np.arange(10)
    batches = list(make_dataloader((X, Y), batch_size=4, shuffle=False,
                                   prefetch=False))
    assert len(batches) == 3  # shuffle=False keeps the ragged tail
    xs, ys = batches[0]
    assert xs.shape == (4, 4, 4, 3)
    np.testing.assert_array_equal(ys, Y[:4])
    np.testing.assert_array_equal(batches[2][0], X[8:])

    # shuffled: every item exactly once per epoch, the ragged tail too
    shuffled = list(make_dataloader((X, Y), batch_size=4, seed=3,
                                    prefetch=False))
    assert [len(b[1]) for b in shuffled] == [4, 4, 2]
    xs_all = np.concatenate([b[0] for b in shuffled])
    np.testing.assert_array_equal(np.sort(xs_all.ravel()), X.ravel())

    with pytest.raises(ValueError, match="mismatch"):
        make_dataloader((X, Y[:5]), batch_size=4)


def test_make_dataloader_batches_as_jax():
    from raw2logit_tpu.data import make_dataloader as jax_make_dataloader
    rng = np.random.default_rng(8)
    X = rng.uniform(size=(11, 4, 4)).astype(np.float32)
    Y = rng.integers(0, 3, 11)
    for kw in ({"shuffle": False}, {"seed": 5}, {"seed": 5,
                                                  "drop_last": True}):
        got = list(make_dataloader((X, Y), 3, prefetch=False, **kw))
        want = list(jax_make_dataloader((X, Y), 3, prefetch=False, **kw))
        assert len(got) == len(want)
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, np.asarray(wx))
            assert np.array_equal(gy, np.asarray(wy))
