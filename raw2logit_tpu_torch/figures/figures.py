"""The stage-GIF and loss-scatter CLI (port of the JAX package's
``figures/figures.py``):

    python -m raw2logit_tpu_torch.figures.figures --experiment_name e \
        --run_name r --output train_vs_val_loss

It takes both of that CLI's surfaces: the reference's flags
(--experiment_name / --run_name / --representation / --step / --gif_name
/ --output {gif,train_vs_val_loss}) resolved against the local run
store, and the direct --run_dir form. --tracking_uri / --local_dir /
--cleanup are accepted for the surface: runs live in the local store
(results/runs), so there is nothing to download or clean. It reads files
only: no device.
"""

import argparse
import glob
import os

from raw2logit_tpu_torch.evaluation.figures import (
    MODE_CHOICES, STEP_CHOICES, loss_scatter, make_stage_gif)


def _resolve_run_dir(args):
    if args.run_dir:
        return args.run_dir
    if not (args.experiment_name and args.run_name):
        raise SystemExit("need --run_dir, or --experiment_name with "
                         "--run_name (reference surface)")
    root = os.path.join(args.local_dir or "results/runs",
                        args.experiment_name, args.run_name)
    if os.path.exists(os.path.join(root, "metrics.jsonl")):
        return root
    # parent runs nest per-fold children <run>_<fold> (tracking/run.py)
    children = sorted(glob.glob(os.path.join(root, args.run_name + "_*")))
    if children:
        return children[0]
    if os.path.isdir(root):
        return root
    raise SystemExit(f"no run found under {root}")


def main(argv=None):
    p = argparse.ArgumentParser(description="results_analysis")
    p.add_argument("--run_dir", default=None,
                   help="local run directory (results/runs/<exp>/<run>)")
    # the reference's surface
    p.add_argument("--tracking_uri", type=str, default=None,
                   help="accepted for reference-CLI compatibility; runs "
                        "are read from the local store")
    p.add_argument("--experiment_name", type=str, default=None)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--representation", type=str, default=None,
                   choices=MODE_CHOICES, help="alias of --mode")
    p.add_argument("--mode", default="processing", choices=MODE_CHOICES)
    p.add_argument("--step", default="gamma_correct", choices=STEP_CHOICES)
    p.add_argument("--gif_name", type=str, default=None,
                   help="output GIF basename (.gif appended)")
    p.add_argument("--local_dir", type=str, default=None,
                   help="run-store root (default results/runs)")
    p.add_argument("--cleanup", type=lambda s: s.lower() != "false",
                   default=True, help="accepted for compatibility (the "
                                      "local store needs no cleanup)")
    p.add_argument("--output", type=str, default=None,
                   choices=["gif", "train_vs_val_loss"])
    p.add_argument("--gif", action="store_true")
    p.add_argument("--scatter", action="store_true")
    p.add_argument("--fps", type=int, default=2)
    args = p.parse_args(argv)

    if args.output == "gif":
        args.gif = True
    elif args.output == "train_vs_val_loss":
        args.scatter = True
    if args.representation:
        args.mode = args.representation
    if not (args.gif or args.scatter):
        raise SystemExit("nothing to do: pass --gif/--scatter or "
                         "--output {gif,train_vs_val_loss}")

    run_dir = _resolve_run_dir(args)
    if args.gif:
        out = (os.path.join(run_dir, args.gif_name + ".gif")
               if args.gif_name else None)
        print("wrote", make_stage_gif(run_dir, stage=args.step,
                                      mode=args.mode, out_path=out,
                                      fps=args.fps))
    if args.scatter:
        print("wrote", loss_scatter(run_dir))


if __name__ == "__main__":
    main()
