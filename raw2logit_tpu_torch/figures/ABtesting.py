"""The A/B and corruption evaluation CLI (port of the JAX package's
``figures/ABtesting.py``, the same modes and flags, and ``--device`` and
``--data_root``):

    python -m raw2logit_tpu_torch.figures.ABtesting --mode ABMakeTable \
        --dataset_name SyntheticMicroscopy --checkpoints_json ckpts.json \
        --state_dict results/runs/e/r/r_0/state_dict.json [--device cpu]

Modes:
  ABMakeTable | ABShowTable | ABShowImages | ABShowAllImages |
  CMakeTable  | CShowTable  | CShowImages  | CShowAllImages

ABMakeTable and CMakeTable aggregate over fold checkpoints (mean and
sample std, at most --N_runs folds) and write
``<out_dir>/tables/{AB,C}table_<dataset>_<augmentation>.json``;
ABShowImages and CShowImages load a checkpoint and render the panels
with the model's predictions; the *ShowAllImages modes render every
pipeline, or every corruption and severity, of one image (no model); the
*ShowTable modes render a table (matplotlib, no device). The models and
pipelines run on ``--device`` (cuda unless given; raises without CUDA).
"""

import argparse
import json
import os

import numpy as np
import torch

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.evaluation.abtesting import (
    CORRUPTION_LIST, DEBAYERS, DENOISINGS, SHARPENINGS, ABTesting,
    ab_show_table, c_show_table, pipeline_grid, pipeline_name)
from raw2logit_tpu_torch.evaluation.corruptions import distort
from raw2logit_tpu_torch.tracking.images import save_image_grid


def build_parser():
    p = argparse.ArgumentParser(description="AB testing")
    p.add_argument("--mode", required=True,
                   choices=["ABMakeTable", "ABShowTable", "ABShowImages",
                            "ABShowAllImages", "CMakeTable", "CShowTable",
                            "CShowImages", "CShowAllImages"])
    p.add_argument("--dataset_name", default="Microscopy",
                   help="a folder dataset (Microscopy, DroneSegmentation, "
                        "Drone, their aliases) under --data_root, or "
                        "SyntheticMicroscopy / SyntheticDrone")
    p.add_argument("--data_root", default="data",
                   help="the folder datasets' root")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--checkpoints_json", default=None,
                   help="json mapping train-pipeline name -> checkpoint "
                        "path or list of per-fold checkpoint paths, or a "
                        "sweep manifest")
    p.add_argument("--state_dict", default=None,
                   help="state_dict.json with valid_indices; pass a comma-"
                        "separated list for per-fold indices")
    p.add_argument("--augmentation", default="weak")
    p.add_argument("--N_runs", type=int, default=5)
    p.add_argument("--severities", type=int, nargs="+",
                   default=[1, 2, 3, 4, 5],
                   help="severity levels for CMakeTable")
    p.add_argument("--severity", type=int, default=1,
                   choices=(1, 2, 3, 4, 5))
    p.add_argument("--out_dir", default="results/ABtesting")
    p.add_argument("--metric", default="accuracy")
    p.add_argument("--download_model", action="store_true",
                   help="accepted for the reference CLI's surface; "
                        "checkpoints load from the local manifest")
    p.add_argument("--network", default="resnet18")
    # the Show-Images modes' pipelines (the reference's flag names)
    p.add_argument("--dm_train", default="bilinear", choices=DEBAYERS)
    p.add_argument("--s_train", default="sharpening_filter",
                   choices=SHARPENINGS)
    p.add_argument("--dn_train", default="gaussian_denoising",
                   choices=DENOISINGS)
    p.add_argument("--dm_test", default="bilinear", choices=DEBAYERS)
    p.add_argument("--s_test", default="sharpening_filter",
                   choices=SHARPENINGS)
    p.add_argument("--dn_test", default="gaussian_denoising",
                   choices=DENOISINGS)
    p.add_argument("--transform", default="identity",
                   help="corruption for CShowImages")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the models and pipelines run: cuda (the "
                        "default; raises without CUDA) or cpu")
    return p


def _load_valid_indices(args, ab):
    if not args.state_dict:
        return list(range(len(ab.dataset)))
    per_fold = []
    for path in args.state_dict.split(","):
        with open(path) as fh:
            per_fold.append(json.load(fh)["valid_indices"])
    return per_fold if len(per_fold) > 1 else per_fold[0]


def _load_checkpoints(args):
    """The --checkpoints_json map; a sweep manifest gives its flat
    pipeline -> checkpoints map, and its per-fold state dicts for the
    valid indices unless --state_dict is given (every sweep run shares
    the k-fold seed, so any pipeline's folds carry the same split)."""
    assert args.checkpoints_json, "--checkpoints_json required"
    with open(args.checkpoints_json) as fh:
        checkpoints = json.load(fh)
    if "jobs" in checkpoints and "checkpoints" in checkpoints:
        manifest = checkpoints
        checkpoints = manifest["checkpoints"]
        assert checkpoints, "manifest has no completed runs"
        if not args.state_dict and manifest.get("state_dicts"):
            args.state_dict = ",".join(
                next(iter(manifest["state_dicts"].values())))
    return checkpoints


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    table_path = os.path.join(
        args.out_dir, "tables",
        f"{'AB' if args.mode.startswith('AB') else 'C'}table_"
        f"{args.dataset_name}_{args.augmentation}.json")

    if args.mode in ("ABShowTable", "CShowTable"):
        show = ab_show_table if args.mode == "ABShowTable" else c_show_table
        print(f"wrote {show(table_path, metric=args.metric)}")
        return

    checkpoints = {}
    if args.mode in ("ABMakeTable", "CMakeTable", "ABShowImages",
                     "CShowImages"):
        checkpoints = _load_checkpoints(args)

    device = resolve_device(None if args.device == "cuda" else args.device)
    ab = ABTesting(args.dataset_name, batch_size=args.batch_size,
                   data_root=args.data_root,
                   severity=args.severity, device=device)
    valid_indices = _load_valid_indices(args, ab)

    if args.mode == "ABMakeTable":
        ab.ab_make_table(checkpoints, valid_indices, table_path,
                         network=args.network, n_runs=args.N_runs)
    elif args.mode == "CMakeTable":
        ab.c_make_table(checkpoints, valid_indices, table_path,
                        network=args.network, n_runs=args.N_runs,
                        severities=tuple(args.severities))
    elif args.mode == "ABShowImages":
        train_pip = (args.dm_train, args.s_train, args.dn_train)
        test_pip = (args.dm_test, args.s_test, args.dn_test)
        tname = pipeline_name(*train_pip)
        assert tname in checkpoints, \
            f"no checkpoint for train pipeline {tname} in --checkpoints_json"
        out_dir = os.path.join(
            args.out_dir, "imgs",
            f"{args.dataset_name}_{args.augmentation}_"
            f"{args.dm_train[:2]}{args.s_train[0]}{args.dn_train[:2]}_"
            f"{args.dm_test[:2]}{args.s_test[0]}{args.dn_test[:2]}")
        summary = ab.ab_show_images(checkpoints[tname], valid_indices,
                                    train_pip, test_pip, out_dir,
                                    network=args.network)
        print(json.dumps(summary))
    elif args.mode == "CShowImages":
        test_pip = (args.dm_test, args.s_test, args.dn_test)
        tname = pipeline_name(*test_pip)
        assert tname in checkpoints, \
            f"no checkpoint for pipeline {tname} in --checkpoints_json"
        out_dir = os.path.join(args.out_dir.replace("ABtesting", "Ctesting"),
                               "imgs")
        summary = ab.c_show_images(checkpoints[tname], valid_indices,
                                   test_pip, args.transform, args.severity,
                                   out_dir, network=args.network)
        print(json.dumps(summary))
    else:
        _show_all_images(args, ab, valid_indices)
    print(f"done: {args.mode}")


def _show_all_images(args, ab, valid_indices):
    """The galleries of one image, no model: all 12 pipelines
    (ABShowAllImages), or every corruption at severities 1..5 of the test
    pipeline, draws from generators seeded 0 (CShowAllImages)."""
    first = valid_indices[0] if valid_indices and \
        not isinstance(valid_indices[0], (list, tuple)) else 0
    raw = torch.as_tensor(ab.dataset[first][0], device=ab.device)[None]
    out_dir = os.path.join(args.out_dir, "images", args.dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    with torch.no_grad():
        if args.mode == "ABShowAllImages":
            for pip in pipeline_grid():
                save_image_grid(ab._pipeline(*pip)(raw), os.path.join(
                    out_dir, f"{pipeline_name(*pip)}.png"))
            return
        rgb = ab._pipeline(args.dm_test, args.s_test, args.dn_test)(raw)
        for corr in CORRUPTION_LIST:
            row = [distort(rgb, corr, sev,
                           torch.Generator(ab.device).manual_seed(0),
                           np.random.default_rng(0))[0]
                   for sev in range(1, 6)]
            save_image_grid(torch.stack(row), os.path.join(
                out_dir, f"{corr}.png"))


if __name__ == "__main__":
    main()
