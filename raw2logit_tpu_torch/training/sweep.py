"""The experiment-grid sweep (port of ``raw2logit_tpu/training/sweep.py``):

    python -m raw2logit_tpu_torch.training.sweep --epochs 1 \
        [--shard i --n_shards n] [--resume] [--device cpu]

12 static pipelines x augmentations x datasets, each grid point one
process of the port's training CLI (``python -m
raw2logit_tpu_torch.training.train``), sharded over hosts with
``--shard i/n``. The manifest (``--out``) is rewritten after every job:
per '<dataset>/<augmentation>' config the pipelines' per-fold checkpoints
(``checkpoints/classifier.pt``) and state dicts, a flat view of them for
a single-config sweep, and the jobs with their return codes. It is what
``raw2logit_tpu_torch.figures.ABtesting --checkpoints_json`` reads.
``--resume`` skips the jobs recorded as done whose ``state_dict.json``
files are still there and retrains the others.
"""

import argparse
import json
import os
import subprocess
import sys

from raw2logit_tpu_torch.evaluation.abtesting import (pipeline_grid,
                                                      pipeline_name)

TRAIN_MODULE = "raw2logit_tpu_torch.training.train"
# the directory holding the package, so that a job finds it from any cwd
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_grid(datasets, augmentations, epochs, batch_size, lr, n_splits,
               extra_flags=()):
    jobs = []
    for ds in datasets:
        for aug in augmentations:
            for (db, sh, dn) in pipeline_grid():
                name = pipeline_name(db, sh, dn)
                run_name = f"{ds}_{aug}_{name}"
                argv = ["--dataset", ds, "--processing_mode", "static",
                        "--sp_debayer", db, "--sp_sharpening", sh,
                        "--sp_denoising", dn,
                        "--augmentation", aug,
                        "--epochs", str(epochs),
                        "--batch_size", str(batch_size),
                        "--lr", str(lr), "--n_splits", str(n_splits),
                        "--experiment_name", f"sweep_{ds}",
                        "--run_name", run_name, *extra_flags]
                jobs.append({"run_name": run_name, "pipeline": name,
                             "dataset": ds, "augmentation": aug,
                             "argv": argv})
    return jobs


def _fold_dirs(job):
    """Per-fold run directories a successful job must have left on disk."""
    n_splits = int(job["argv"][job["argv"].index("--n_splits") + 1])
    run_dir = os.path.join("results", "runs", f"sweep_{job['dataset']}",
                           job["run_name"])
    return [os.path.join(run_dir, f"{job['run_name']}_{k}")
            for k in range(n_splits)]


def _job_artifacts_exist(job):
    return all(os.path.exists(os.path.join(d, "state_dict.json"))
               for d in _fold_dirs(job))


def _empty_manifest():
    return {"jobs": [], "checkpoints": {}, "state_dicts": {}, "configs": {}}


def _flat_view(manifest):
    """A single-config sweep's config also as the top-level maps."""
    if len(manifest["configs"]) == 1:
        only = next(iter(manifest["configs"].values()))
        manifest["checkpoints"] = only["checkpoints"]
        manifest["state_dicts"] = only["state_dicts"]


def _resumed(out):
    """The manifest at ``out`` with only the jobs that are done and whose
    artifacts are still there (the others' checkpoint paths dropped), and
    the names of those jobs."""
    try:
        with open(out) as fh:
            manifest = json.load(fh)
    except ValueError:
        return _empty_manifest(), set()
    kept = [j for j in manifest.get("jobs", [])
            if j.get("returncode") == 0 and _job_artifacts_exist(j)]
    lost = [j for j in manifest.get("jobs", [])
            if j.get("returncode") == 0 and not _job_artifacts_exist(j)]
    for j in lost:
        # checkpoints vanished: retrain, and drop the stale paths so that
        # a truncated resume never hands dead paths to the A/B harness
        cfg = manifest.get("configs", {}).get(
            f"{j['dataset']}/{j['augmentation']}", {})
        cfg.get("checkpoints", {}).pop(j["pipeline"], None)
        cfg.get("state_dicts", {}).pop(j["pipeline"], None)
        print(f"resume: artifacts missing, will retrain: {j['run_name']}")
    manifest["jobs"] = kept
    manifest.setdefault("configs", {})
    print(f"resuming: {len(kept)} jobs already complete")
    return manifest, {j["run_name"] for j in kept}


def run_sweep(jobs, shard=0, n_shards=1, dry_run=False,
              python=sys.executable, out=None, resume=False, device=None):
    """Run this shard's jobs, each ``python -m`` the training CLI (with
    ``--device device`` when given). The manifest maps each
    '<dataset>/<augmentation>' config's pipelines to their per-fold
    classifier checkpoints and state dicts; the top-level maps are that
    of a single-config sweep. With ``out`` it is rewritten after every
    job, and ``resume`` skips the jobs an existing manifest there records
    as done (``_resumed``). Returns the manifest."""
    manifest, done = ((_resumed(out)) if resume and out
                      and os.path.exists(out) else (_empty_manifest(), set()))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (PACKAGE_ROOT, os.environ.get("PYTHONPATH")) if p))

    def _flush():
        if not out:
            return
        manifest.pop("checkpoints", None)
        manifest.pop("state_dicts", None)
        _flat_view(manifest)
        if os.path.dirname(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(manifest, fh, indent=2)
        os.replace(tmp, out)

    for i, job in enumerate(jobs):
        if i % n_shards != shard:
            continue
        if job["run_name"] in done:
            print(f"[{i + 1}/{len(jobs)}] skip (done): {job['run_name']}")
            continue
        cmd = [python, "-m", TRAIN_MODULE, *job["argv"],
               *(["--device", device] if device else [])]
        print(f"[{i + 1}/{len(jobs)}] {' '.join(cmd)}", flush=True)
        if dry_run:
            continue
        rc = subprocess.run(cmd, env=env).returncode
        job = dict(job, returncode=rc)
        manifest["jobs"].append(job)
        if rc == 0:
            folds = _fold_dirs(job)
            cfg = manifest["configs"].setdefault(
                f"{job['dataset']}/{job['augmentation']}",
                {"checkpoints": {}, "state_dicts": {}})
            cfg["checkpoints"][job["pipeline"]] = [
                os.path.join(d, "checkpoints", "classifier.pt")
                for d in folds]
            cfg["state_dicts"][job["pipeline"]] = [
                os.path.join(d, "state_dict.json") for d in folds]
        _flush()
    _flat_view(manifest)
    return manifest


def main(argv=None):
    p = argparse.ArgumentParser(description="12-pipeline training sweep")
    p.add_argument("--datasets", nargs="+", default=["Microscopy"])
    p.add_argument("--augmentations", nargs="+", default=["weak"])
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--precompute_static", action="store_true",
                   help="run the static ISP once over the dataset (the "
                        "training CLI's --precompute_static)")
    p.add_argument("--check_val_every_n_epoch", type=int, default=1)
    p.add_argument("--n_splits", type=int, default=5)
    p.add_argument("--shard", type=int, default=0,
                   help="this host's shard of the grid")
    p.add_argument("--n_shards", type=int, default=1)
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--resume", action="store_true",
                   help="skip jobs already recorded successfully in the "
                        "manifest at --out")
    p.add_argument("--out", default="results/sweep_manifest.json")
    p.add_argument("--device", default=None,
                   help="passed to every job (the CLI's default is cuda)")
    args = p.parse_args(argv)

    extra = []
    if args.weight_decay:
        extra += ["--weight_decay", str(args.weight_decay)]
    if args.lr_schedule != "constant":
        extra += ["--lr_schedule", args.lr_schedule]
    if args.precompute_static:
        extra += ["--precompute_static"]
    if args.check_val_every_n_epoch != 1:
        extra += ["--check_val_every_n_epoch",
                  str(args.check_val_every_n_epoch)]
    jobs = build_grid(args.datasets, args.augmentations, args.epochs,
                      args.batch_size, args.lr, args.n_splits,
                      extra_flags=tuple(extra))
    manifest = run_sweep(jobs, shard=args.shard, n_shards=args.n_shards,
                         dry_run=args.dry_run, out=args.out,
                         resume=args.resume, device=args.device)
    if not args.dry_run:
        print(f"manifest -> {args.out}")
    return manifest


if __name__ == "__main__":
    main()
