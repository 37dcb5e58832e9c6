"""PyTorch port vs the JAX package: the mmap tile store.

The JAX package's six cases (tests/test_tilestore.py) run on the port;
a store written by each package is read by the other, the files byte
for byte equal; a Subset of a store reads its mapped rows through the
Loader; and the build raises, without a fallback, where the compiler is
missing or fails.
"""

import os
import threading

import numpy as np
import pytest

from raw2logit_tpu.data.tilestore import TileStore as JaxTileStore
from raw2logit_tpu.data.tilestore import build_store as jax_build_store

from raw2logit_tpu_torch.data import (Loader, Subset,
                                      SyntheticRawClassification,
                                      SyntheticRawSegmentation)
from raw2logit_tpu_torch.data import tilestore
from raw2logit_tpu_torch.data.tilestore import TileStore, build_store


class U16DS:
    task = "classification"

    def __len__(self):
        return 3

    def __getitem__(self, i):
        rng = np.random.default_rng(i)
        return (rng.integers(0, 2 ** 16, (16, 16)).astype(np.uint16),
                i % 2)


def test_classification_roundtrip(tmp_path):
    ds = SyntheticRawClassification(n=6, h=32, w=32, seed=5)
    path = str(tmp_path / "cls.r2l")
    build_store(ds, path)
    store = TileStore(path, task="auto")
    assert len(store) == 6
    assert store.task == "classification"
    imgs, labels = store.gather([0, 3, 5])
    assert imgs.shape == (3, 32, 32) and labels.dtype == np.int64
    for j, i in enumerate([0, 3, 5]):
        x, y = ds[i]
        assert np.array_equal(imgs[j], x)
        assert labels[j] == y
    store.close()


def test_uint16_normalization(tmp_path):
    ds = U16DS()
    path = str(tmp_path / "u16.r2l")
    build_store(ds, path, dtype=np.uint16)
    store = TileStore(path, task="auto")
    imgs, _ = store.gather([1])
    want = np.asarray(ds[1][0], np.float32) / 65535.0
    np.testing.assert_allclose(imgs[0], want, atol=1e-7)
    # x * (1 / 65535) against x / 65535: at most one float32 ulp apart
    ulps = np.abs(imgs[0].view(np.int32).astype(np.int64)
                  - want.view(np.int32))
    assert ulps.max() <= 1
    store.close()


def test_segmentation_masks(tmp_path):
    ds = SyntheticRawSegmentation(n=4, h=32, w=32, seed=2)
    path = str(tmp_path / "seg.r2l")
    build_store(ds, path)
    store = TileStore(path, task="auto")
    assert store.task == "segmentation"
    imgs, masks = store.gather([2, 0])
    assert masks.shape == (2, 32, 32)
    assert np.array_equal(masks[0], ds[2][1])
    assert np.array_equal(imgs[1], ds[0][0])
    with pytest.raises(ValueError, match="store is segmentation"):
        TileStore(path, task="classification")
    store.close()


def test_store_with_loader(tmp_path):
    ds = SyntheticRawClassification(n=8, h=32, w=32, seed=1)
    path = str(tmp_path / "ld.r2l")
    build_store(ds, path)
    store = TileStore(path, task="auto")
    loader = Loader(store, batch_size=4, shuffle=False)
    xs, ys = next(iter(loader))
    assert xs.shape == (4, 32, 32)
    assert np.array_equal(ys, [ds[i][1] for i in range(4)])
    store.close()


def test_subset_of_store_gathers_mapped_rows(tmp_path):
    """Subset routes gather through its index list: forwarded as it is,
    the store would read the subset's positions as its own rows."""
    ds = SyntheticRawClassification(n=8, h=16, w=16, seed=4)
    path = str(tmp_path / "sub.r2l")
    build_store(ds, path)
    store = TileStore(path, task="auto")
    sub = Subset(store, [5, 2, 7])
    imgs, labels = sub.gather([0, 2])
    assert np.array_equal(imgs[0], ds[5][0])
    assert np.array_equal(imgs[1], ds[7][0])
    assert list(labels) == [ds[5][1], ds[7][1]]
    xs, _ = next(iter(Loader(sub, batch_size=3, shuffle=False)))
    assert np.array_equal(xs[1], ds[2][0])
    # a Subset of a plain dataset has no gather
    assert not hasattr(Subset(ds, [0, 1]), "gather")
    store.close()


def test_truncated_store_rejected(tmp_path):
    """A store cut short fails at open, not in a later gather."""
    ds = SyntheticRawClassification(n=4, h=16, w=16, seed=0)
    path = str(tmp_path / "trunc.r2l")
    build_store(ds, path)
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(size - 64)
    with pytest.raises(IOError, match="cannot open"):
        TileStore(path, task="auto")


DATASETS = {
    "classification": lambda: SyntheticRawClassification(n=5, h=24, w=16,
                                                         seed=3),
    "segmentation": lambda: SyntheticRawSegmentation(n=3, h=16, w=24,
                                                     seed=6),
    "uint16": U16DS,
}


@pytest.mark.parametrize("kind", sorted(DATASETS))
def test_each_package_reads_the_other_s_store(tmp_path, kind):
    ds = DATASETS[kind]()
    dtype = np.uint16 if kind == "uint16" else np.float32
    jpath, ppath = str(tmp_path / "j.r2l"), str(tmp_path / "p.r2l")
    jax_build_store(ds, jpath, dtype=dtype)
    build_store(ds, ppath, dtype=dtype)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()
    order = list(range(len(ds)))[::-1]
    port_on_jax, jax_on_port = TileStore(jpath), JaxTileStore(ppath)
    try:
        for got, want in zip(port_on_jax.gather(order),
                             jax_on_port.gather(order)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert port_on_jax.task == jax_on_port.task
    finally:
        port_on_jax.close()
        jax_on_port.close()


def test_bad_indices_closed_stores_and_float_counts_raise(tmp_path):
    ds = SyntheticRawClassification(n=4, h=16, w=16, seed=0)
    path = str(tmp_path / "a.r2l")
    build_store(ds, path)
    store = TileStore(path)
    for bad in ([4], [-1], [0, 7]):
        with pytest.raises(IndexError):
            store.gather(bad)
    assert store.gather([])[0].shape == (0, 16, 16)
    store.close()
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.gather([0])
    # normalised floats into a uint16 store would be cut to 0 and 1
    with pytest.raises(ValueError, match="integer counts"):
        build_store(ds, str(tmp_path / "u.r2l"), dtype=np.uint16)


def test_close_while_a_loader_prefetches(tmp_path):
    """close() waits for a gather in flight; later gathers raise instead
    of reading unmapped memory."""
    ds = SyntheticRawClassification(n=64, h=32, w=32, seed=2)
    path = str(tmp_path / "race.r2l")
    build_store(ds, path)
    for _ in range(5):
        store = TileStore(path, n_threads=2)
        seen, errors = [], []

        def consume():
            try:
                for xs, _ in Loader(store, batch_size=4, shuffle=True):
                    seen.append(xs.shape)
            except ValueError as e:
                errors.append(str(e))
        t = threading.Thread(target=consume)
        t.start()
        store.close()
        t.join(timeout=30)
        assert not t.is_alive()
        assert all(s == (4, 32, 32) for s in seen)
        assert all("closed" in e for e in errors)


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """A build directory of this test's own and no cached library; the
    cache is cleared again afterwards, so later tests load the library
    from the real build directory."""
    monkeypatch.setattr(tilestore, "BUILD_DIR", str(tmp_path / "build"))
    tilestore.load_library.cache_clear()
    yield
    tilestore.load_library.cache_clear()


def test_a_missing_compiler_raises(fresh_build, monkeypatch, tmp_path):
    ds = SyntheticRawClassification(n=2, h=8, w=8)
    path = str(tmp_path / "s.r2l")
    build_store(ds, path)  # numpy only
    monkeypatch.setattr(tilestore.shutil, "which", lambda name: None)
    with pytest.raises(FileNotFoundError, match="no C.. compiler"):
        TileStore(path)
    assert not os.path.exists(tilestore.BUILD_DIR)


def test_a_failed_build_raises_with_its_log(fresh_build, monkeypatch,
                                            tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tilestore, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match=r"(?s)failed on .*error"):
        tilestore.load_library()
    assert not [f for f in os.listdir(tilestore.BUILD_DIR)
                if f.endswith(".so")]


def test_the_library_is_named_by_its_inputs(fresh_build):
    cxx = tilestore.compiler()
    path = tilestore.library_path(cxx)
    assert os.path.dirname(path) == tilestore.BUILD_DIR
    assert os.path.basename(path).startswith("libtilestore-")
    assert tilestore.build() == path and os.path.exists(path)
    assert tilestore.build() == path  # built once
