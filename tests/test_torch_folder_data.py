"""PyTorch port vs the JAX package: the folder datasets, their tiling
builders and the tiling functions, on folders written here (TIFF and PNG
through PIL, as tests/test_realdata_paths.py writes them, and DNGs
through the port's writer).

Every dataset class and ``get_dataset`` alias of the port is held to the
JAX package's item by item and bitwise; the tiled datasets are built on
first use by each package into a copy of one tree, and the files and the
CSV manifest they write are held byte for byte. Then the training CLI,
``Predictor.from_run``, the serving CLI and ``ABTesting`` on a folder
dataset, on the CPU. The dataset downloads are stubbed to raise: nothing
here reaches the network.
"""

import json
import os
import shutil
import sys

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from raw2logit_tpu.data import datasets as jdata
from raw2logit_tpu.data import download as jdownload
from raw2logit_tpu.data import tiling as jtiling

from raw2logit_tpu_torch.data import datasets as pdata
from raw2logit_tpu_torch.data import download as pdownload
from raw2logit_tpu_torch.data import tiling as ptiling
from raw2logit_tpu_torch.data import write_dng
from raw2logit_tpu_torch.evaluation import abtesting as pab
from raw2logit_tpu_torch import serving
from raw2logit_tpu_torch.training import train as cli

TILE = 64
SIZE = 64  # microscopy images
MICRO = ([("lyt_%02d" % i, "LYT") for i in range(6)]
         + [("mon_%02d" % i, "MON") for i in range(5)]
         + [("bas_%02d" % i, "BAS") for i in range(2)]
         + [("Ma190c_lame3_zone13_composite_Mcropped_2", "LYT")])


def _offline(data_root="data", force_download=False):
    raise FileNotFoundError(f"dataset download stubbed in tests "
                            f"({data_root})")


@pytest.fixture(scope="module", autouse=True)
def no_downloads():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jdownload, pdownload):
            mp.setattr(mod, "download_drone_dataset", _offline)
            mp.setattr(mod, "download_microscopy_dataset", _offline)
        yield


def full_frames(seed, n=2, h=2 * TILE, w=3 * TILE):
    """uint16 drone frames and binary masks for a 2x3 grid of tiles: one
    tile fully covered, one half covered, the rest empty."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = (rng.uniform(0.05, 0.95, size=(h, w)) * 65535).astype(
            np.uint16)
        mask = np.zeros((h, w), np.uint8)
        mask[:TILE, :TILE] = 1
        mask[:TILE // 2, TILE:2 * TILE] = 1
        out.append((img, mask))
    return out


def write_tree(root):
    """The microscopy (raw at two exposures, RGB) and drone (full frames
    at two exposures) folders, under ``root``."""
    rng = np.random.default_rng(3)
    label_dir = os.path.join(root, "microscopy", "labels")
    os.makedirs(label_dir)
    with open(os.path.join(label_dir, "Ma190c_annotations.dat"), "wb") as fh:
        fh.write("\n".join(f"{n} {c}" for n, c in MICRO).encode())
    for scale, shape, dtype in (("raw_scale100", (SIZE, SIZE), np.uint16),
                                ("raw_scale050", (SIZE, SIZE), np.uint16),
                                ("rgb_scale100", (SIZE, SIZE, 3), np.uint8)):
        img_dir = os.path.join(root, "microscopy", "images", scale)
        os.makedirs(img_dir)
        top = np.iinfo(dtype).max
        for name, _ in MICRO:
            arr = (rng.uniform(0, 1, shape) * top).astype(dtype)
            Image.fromarray(arr).save(os.path.join(img_dir, f"{name}.tiff"))
    mask_dir = os.path.join(root, "drone", "masks_full")
    os.makedirs(mask_dir)
    for seed, scale in ((0, "raw_scale100"), (1, "raw_scale050")):
        img_dir = os.path.join(root, "drone", "images_full", scale)
        os.makedirs(img_dir)
        for i, (img, mask) in enumerate(full_frames(seed)):
            Image.fromarray(img).save(os.path.join(img_dir, f"f{i:02d}.tif"))
            Image.fromarray(mask > 0).save(
                os.path.join(mask_dir, f"f{i:02d}.png"))


def tree_bytes(root, *subdirs):
    out = {}
    for sub in subdirs:
        for dirpath, _, files in os.walk(os.path.join(root, *sub.split("/"))):
            for f in files:
                path = os.path.join(dirpath, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One tree, copied for each package; each then builds the tiled drone
    datasets on first use in its own copy."""
    base = tmp_path_factory.mktemp("folder_data")
    src = str(base / "src")
    write_tree(src)
    j, p = str(base / "jax"), str(base / "port")
    shutil.copytree(src, j)
    shutil.copytree(src, p)
    for name in ("DS", "DC"):
        jdata.get_dataset(name, data_root=j, tile_size=TILE)
        pdata.get_dataset(name, data_root=p, tile_size=TILE)
    return {"j": j, "p": p}


def assert_same_dataset(j, p, j_root, p_root):
    assert type(j).__name__ == type(p).__name__
    assert len(j) == len(p) > 0
    assert j.task == p.task
    assert getattr(j, "classes", None) == getattr(p, "classes", None)
    assert (getattr(j, "camera_parameters", None)
            == getattr(p, "camera_parameters", None))
    for attr in ("images", "masks"):
        if hasattr(j, attr):
            assert ([os.path.relpath(f, j_root) for f in getattr(j, attr)]
                    == [os.path.relpath(f, p_root) for f in getattr(p, attr)])
    for i in range(len(j)):
        (xj, yj), (xp, yp) = j[i], p[i]
        assert xj.dtype == xp.dtype == np.float32
        assert xj.shape == xp.shape and np.array_equal(xj, xp)
        assert type(yj) is type(yp)
        assert np.array_equal(yj, yp)


DRONE_TILED = {"tile_size": TILE}
CASES = ([(a, 1.0, DRONE_TILED) for a in (
    "DC", "Drone", "DroneClassification", "DroneDatasetClassificationTiled",
    "DS", "DroneSegmentation", "DroneDatasetSegmentationTiled")]
    + [(a, r, {}) for a in ("M", "Microscopy", "MicroscopyDataset", "DSF",
                            "DroneDatasetSegmentationFull")
       for r in (1.0, 0.5)]
    + [(a, 1.0, {"bits": 8}) for a in ("MRGB", "MicroscopyRGB",
                                       "MicroscopyDatasetRGB")])


@pytest.mark.parametrize("alias,I_ratio,kwargs", CASES)
def test_get_dataset_matches_jax(roots, alias, I_ratio, kwargs):
    j = jdata.get_dataset(alias, I_ratio=I_ratio, data_root=roots["j"],
                          **kwargs)
    p = pdata.get_dataset(alias, I_ratio=I_ratio, data_root=roots["p"],
                          **kwargs)
    assert_same_dataset(j, p, roots["j"], roots["p"])


def test_classes_and_filters(roots):
    """BAS (2 examples) is filtered, the known invalid file dropped, the
    exposure picks the folder."""
    ds = pdata.get_dataset("Microscopy", I_ratio=0.5, data_root=roots["p"])
    assert ds.classes == ["LYT", "MON"] and len(ds) == 11
    assert ds.img_dir.endswith(os.path.join("images", "raw_scale050"))
    tiled = pdata.get_dataset("DC", data_root=roots["p"], tile_size=TILE)
    assert tiled.classes == ["car", "no car"]
    assert tiled.df["label"].count(0) == tiled.df["label"].count(1) == 4


@pytest.mark.parametrize("what", ["DroneDatasetSegmentationFull",
                                  "MicroscopyDataset",
                                  "DroneDatasetSegmentationTiled",
                                  "DroneDatasetClassificationTiled"])
@pytest.mark.parametrize("I_ratio", [0.3, 2.0])
def test_an_invalid_exposure_raises_as_in_jax(roots, what, I_ratio):
    with pytest.raises(AssertionError, match="not in"):
        getattr(jdata, what)(I_ratio=I_ratio, data_root=roots["j"])
    with pytest.raises(ValueError, match="not in"):
        getattr(pdata, what)(I_ratio=I_ratio, data_root=roots["p"])


def test_tiles_and_manifest_are_byte_identical(roots):
    subs = ("drone/images_tiles_64", "drone/masks_tiles_64",
            "drone/classification")
    got, want = tree_bytes(roots["p"], *subs), tree_bytes(roots["j"], *subs)
    assert sorted(got) == sorted(want) and len(got) == 2 * 4 + 2 * 8 + 1
    for rel in want:
        assert got[rel] == want[rel], rel


def test_each_package_reads_the_other_s_manifest(roots):
    rel = os.path.join("drone", "classification",
                       f"dataset_tiles_{TILE}_72_0.01.csv")
    jax_read = jdata.read_label_csv(pd.read_csv(os.path.join(roots["p"],
                                                             rel)))
    port_read = pdata.read_label_csv(pdata.read_manifest(
        os.path.join(roots["j"], rel)))
    assert jax_read == port_read
    assert port_read[0][0] == "00_00000.tif" and port_read[1][:2] == [0, 0]
    # the port's writer writes what pandas writes
    ids, labels = ["00_00001", "01_00010"], [1, 0]
    path = os.path.join(roots["p"], "manifest.csv")
    pdata.write_manifest(path, ids, labels)
    pd.DataFrame({"file name": ids, "label": labels}).to_csv(
        path + ".pd", index=False)
    with open(path, "rb") as a, open(path + ".pd", "rb") as b:
        assert a.read() == b.read()


def test_read_label_csv_on_a_dataframe_as_jax():
    df = pd.DataFrame({"file name": ["00_00001", "00_00002"],
                       "label": ["1", 0]})
    assert pdata.read_label_csv(df) == jdata.read_label_csv(df) == (
        ["00_00001.tif", "00_00002.tif"], [1, 0])


def test_read_label_file_as_jax(roots):
    path = os.path.join(roots["p"], "microscopy", "labels",
                        "Ma190c_annotations.dat")
    assert pdata.read_label_file(path) == jdata.read_label_file(path)


def test_multi_intensity_as_jax(roots):
    def both(pkg, root):
        return pkg.MultiIntensity([
            pkg.MicroscopyDataset(I_ratio=r, data_root=root)
            for r in (1.0, 0.5)])
    j, p = both(jdata, roots["j"]), both(pdata, roots["p"])
    assert len(p) == len(j) == 22
    assert p.classes == j.classes and p.task == j.task
    assert p.camera_parameters == j.camera_parameters
    for i in range(len(j)):
        assert np.array_equal(j[i][0], p[i][0]) and j[i][1] == p[i][1]


def dng_folders(root):
    """Classification DNGs and segmentation DNG images and masks."""
    rng = np.random.default_rng(7)
    paths = []
    for d in ("cls", "seg_img", "seg_mask"):
        os.makedirs(os.path.join(root, d))
    for i in range(5):
        img = rng.integers(0, 2 ** 16, (32, 48), dtype=np.uint16)
        for d in ("cls", "seg_img"):
            path = os.path.join(root, d, f"t{i:02d}.dng")
            write_dng(path, img)
            if d == "cls":
                paths.append(path)
        write_dng(os.path.join(root, "seg_mask", f"t{i:02d}_mask.dng"),
                  (rng.uniform(size=(32, 48)) < 0.3).astype(np.uint16))
    return paths


def test_folder_datasets_over_dngs_as_jax(tmp_path):
    paths = dng_folders(str(tmp_path))
    labels = [2, 0, 1, 1, 2]
    j = jdata.FolderClassification(paths, labels)
    p = pdata.FolderClassification(paths, labels)
    assert_same_dataset(j, p, str(tmp_path), str(tmp_path))
    args = (str(tmp_path / "seg_img"), str(tmp_path / "seg_mask"))
    j, p = jdata.FolderSegmentation(*args), pdata.FolderSegmentation(*args)
    assert_same_dataset(j, p, str(tmp_path), str(tmp_path))
    assert set(np.unique(p[0][1])) == {0.0, 1.0}
    with pytest.raises(ValueError, match="corresponds"):
        pdata.check_image_folder_consistency(["a/x.dng"], ["b/y_mask.dng"])
    with pytest.raises(ValueError, match="mismatch"):
        pdata.check_image_folder_consistency(["a/x.dng"], [])


def test_tiff_and_png_without_pil_raise(tmp_path, monkeypatch):
    """Where PIL is missing (the card's machine) a TIFF or PNG raises an
    ImportError naming PIL; a DNG still reads."""
    tif = str(tmp_path / "a.tif")
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tif)
    dng = str(tmp_path / "a.dng")
    write_dng(dng, np.full((4, 4), 7, np.uint16))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for call in (lambda: pdata.load_image(tif),
                 lambda: ptiling._save_tile(np.zeros((4, 4)), tif),
                 lambda: ptiling.create_tiles_dataset(
                     [], str(tmp_path / "i"), str(tmp_path / "m"))):
        with pytest.raises(ImportError, match="PIL .*DNG"):
            call()
    assert pdata.load_image(dng)[0, 0] == 7.0


def test_a_missing_folder_goes_to_the_port_s_download(tmp_path, monkeypatch):
    calls = []

    def record(data_root="data", force_download=False):
        calls.append((data_root, force_download))
        raise FileNotFoundError("stub")
    monkeypatch.setattr(pdownload, "download_microscopy_dataset", record)
    monkeypatch.setattr(pdownload, "download_drone_dataset", record)
    for name in ("Microscopy", "DSF", "DS", "DC"):
        with pytest.raises(FileNotFoundError, match="stub"):
            pdata.get_dataset(name, data_root=str(tmp_path))
    assert calls == [(str(tmp_path), False)] * 4


@pytest.mark.parametrize("seed,thr", [(0, 0.01), (72, 0.01), (5, 0.2)])
def test_binary_class_detection_as_jax(seed, thr):
    rng = np.random.default_rng(seed + 100)
    X = rng.uniform(size=(40, 8, 8)).astype(np.float32)
    Y = (rng.uniform(size=(40, 8, 8))
         < rng.choice([0.0, 0.005, 0.1, 0.5], size=40)[:, None, None])
    Y = Y.astype(np.float32)
    got = pdata.binary_class_detection(X, Y, seed, thr)
    want = jdata.binary_class_detection(X, Y, seed, thr)
    assert len(got[0]) == len(got[1]) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("shape", [(20, 30), (20, 30, 3), (4, 20, 30),
                                   (2, 20, 30, 3)])
@pytest.mark.parametrize("rois,step", [((4, 5), (2, 3)), ((10, 10),
                                                          (10, 10))])
def test_split_img_as_jax(shape, rois, step):
    x = np.random.default_rng(1).uniform(size=shape).astype(np.float32)
    got = ptiling.split_img(x, ROIs=rois, step=step)
    want = jtiling.split_img(x, ROIs=rois, step=step)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_join_blocks_inverts_split_as_jax():
    x = np.random.default_rng(2).uniform(size=(3, 40, 60))
    blocks = ptiling.split_img(np.moveaxis(x, 0, -1), ROIs=(20, 20),
                               step=(20, 20))
    blocks = np.moveaxis(blocks, -1, 1)
    got = ptiling.join_blocks(blocks, (40, 60))
    assert np.array_equal(got, jtiling.join_blocks(blocks, (40, 60)))
    assert np.array_equal(got, x)
    with pytest.raises(ValueError, match="ndim"):
        ptiling.split_img(np.zeros((1, 2, 3, 4, 5)))


def test_random_rois_as_jax_with_the_same_rng():
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(3, 30, 40, 2)).astype(np.float32)
    Y = rng.uniform(size=(3, 30, 40, 1)).astype(np.float32)
    got = ptiling.random_ROI(X, Y, (16, 8), np.random.default_rng(9))
    want = jtiling.random_ROI(X, Y, (16, 8), np.random.default_rng(9))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    got = ptiling.one2many_random_ROI(X, Y, 6, (16, 8),
                                      np.random.default_rng(4))
    want = jtiling.one2many_random_ROI(X, Y, 6, (16, 8),
                                       np.random.default_rng(4))
    assert got[0].shape == (6, 16, 8, 2)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


# --- the CLI, serving and the evaluation harness on a folder dataset -------

@pytest.fixture(scope="module")
def microscopy_run(roots, tmp_path_factory):
    """``--dataset Microscopy --I_ratio 0.5 --test_run`` through the CLI on
    the CPU, from a working directory whose ``data/`` is the port's tree:
    (the CLI's result, the datasets its get_dataset returned, the working
    directory)."""
    work = str(tmp_path_factory.mktemp("cli"))
    os.symlink(roots["p"], os.path.join(work, "data"))
    seen = []
    real = cli.get_dataset

    def recording(name, **kw):
        seen.append(real(name, **kw))
        return seen[-1]
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setattr(cli, "get_dataset", recording)
        (res,) = cli.main(["--dataset", "Microscopy", "--I_ratio", "0.5",
                           "--test_run", "--batch_size", "2", "--epochs",
                           "1", "--n_splits", "1", "--device", "cpu",
                           "--experiment_name", "fd", "--run_name", "r"])
    return res, seen, work


def test_cli_trains_microscopy_at_the_exposure_given(microscopy_run):
    res, seen, work = microscopy_run
    (ds,) = seen
    assert isinstance(ds, pdata.MicroscopyDataset)
    assert ds.img_dir.endswith(os.path.join("images", "raw_scale050"))
    with open(os.path.join(work, res["run"].dir, "metrics.jsonl")) as fh:
        mets = [json.loads(line) for line in fh]
    assert any("train_loss" in m for m in mets)
    assert all(np.isfinite(m["train_loss"]) for m in mets
               if "train_loss" in m)


def test_from_run_and_serving_on_a_folder_dataset(microscopy_run, roots,
                                                  tmp_path):
    _, _, work = microscopy_run
    root = os.path.join(work, "results", "runs")
    pred = serving.Predictor.from_run(
        "fd", "r", dataset_name="Microscopy", data_root=roots["p"],
        I_ratio=0.5, image_size=SIZE, root=root, device="cpu")
    assert pred.classes == ["LYT", "MON"]
    ds = pdata.MicroscopyDataset(I_ratio=0.5, data_root=roots["p"])
    raw = torch.as_tensor(np.stack([ds[i][0] for i in range(3)]))
    out = pred(raw)
    assert out.shape == (3, 2) and torch.isfinite(out).all()
    # the serving CLI, the dataset under --data_root
    cwd = os.getcwd()
    os.chdir(work)
    try:
        path = serving.main([
            "--experiment_name", "fd", "--run_name", "r", "--image_dir",
            os.path.join(roots["p"], "microscopy", "images", "raw_scale050"),
            "--dataset", "Microscopy", "--data_root", roots["p"],
            "--out", str(tmp_path / "p.jsonl"), "--device", "cpu"])
    finally:
        os.chdir(cwd)
    with open(path) as fh:
        assert len(fh.readlines()) == len(MICRO)


def test_abtesting_reads_its_data_root(roots):
    ab = pab.ABTesting("Microscopy", data_root=roots["p"], batch_size=4,
                       device="cpu")
    want = jdata.MicroscopyDataset(data_root=roots["j"])
    assert_same_dataset(want, ab.dataset, roots["j"], roots["p"])
    assert ab.task == "classification"
