"""Drift optimisation (offline, synthetic; port of
``examples/drift_optimization.py``): a frozen default ISP against an ISP
trained jointly with the classifier, from the same seed (so the same
classifier init), and their learning curves in
``<out_dir>/drift_optimization.json`` (``results/torch/`` by default):
per-epoch validation loss and accuracy of both arms, the mean loss over
training, the epochs until accuracy >= 0.99, and whether joint training
matches or beats the frozen ISP on both (once both arms sit at accuracy
1.0 the final losses differ only by noise, so the comparison is on the
curve, not its end).

    python -m raw2logit_tpu_torch.examples.drift_optimization \
        [--epochs 8] [--use_pallas] [--device cpu]

Extra flags pass through to the training CLI.
"""

import argparse
import json
import os

from raw2logit_tpu_torch.training.train import build_parser, run_train


def _curves(results):
    metrics = results[0]["run"].read_metrics()
    return ([m["val_loss"] for m in metrics if "val_loss" in m],
            [m["val_accuracy"] for m in metrics if "val_accuracy" in m])


def _epochs_to(accs, thresh=0.99):
    """The first epoch (1-based) whose accuracy is >= thresh, or None."""
    return next((i + 1 for i, a in enumerate(accs) if a >= thresh), None)


def run_optimization(epochs=8, batch_size=8, out_dir="results/torch",
                     extra=()):
    common = ["--dataset", "SyntheticMicroscopy", "--processing_mode",
              "parametrized", "--epochs", str(epochs),
              "--batch_size", str(batch_size), "--n_splits", "1",
              "--lr", "1e-3", "--experiment_name", "drift_opt",
              *list(extra)]

    frozen = run_train(build_parser().parse_args(
        common + ["--freeze_processor", "--run_name", "frozen_isp"]))
    joint = run_train(build_parser().parse_args(
        common + ["--run_name", "joint_isp"]))

    lf, af = _curves(frozen)
    lj, aj = _curves(joint)
    mean_f = sum(lf) / len(lf)
    mean_j = sum(lj) / len(lj)
    e_f, e_j = _epochs_to(af), _epochs_to(aj)
    report = {
        "epochs": epochs,
        "frozen_val_loss": [round(float(v), 4) for v in lf],
        "joint_val_loss": [round(float(v), 4) for v in lj],
        "frozen_val_accuracy": [round(float(v), 4) for v in af],
        "joint_val_accuracy": [round(float(v), 4) for v in aj],
        "final_frozen_val_loss": round(float(lf[-1]), 4),
        "final_joint_val_loss": round(float(lj[-1]), 4),
        "mean_frozen_val_loss": round(float(mean_f), 4),
        "mean_joint_val_loss": round(float(mean_j), 4),
        "epochs_to_acc99_frozen": e_f,
        "epochs_to_acc99_joint": e_j,
        # lower mean val loss and no later convergence
        "joint_better": bool(mean_j <= mean_f
                             and (e_j or epochs + 1) <= (e_f or epochs + 1)),
    }
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "drift_optimization.json")
    with open(out, "w") as fh:
        json.dump(report, fh, indent=2)
    print(f"frozen-ISP val loss per epoch:  {report['frozen_val_loss']}")
    print(f"joint-ISP  val loss per epoch:  {report['joint_val_loss']}")
    print(f"mean val loss: frozen {mean_f:.4f} vs joint {mean_j:.4f}; "
          f"epochs to acc>=0.99: frozen {e_f} vs joint {e_j} "
          f"({'joint better' if report['joint_better'] else 'frozen better'})"
          f" -> {out}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=8)
    args, extra = p.parse_known_args(argv)
    return run_optimization(epochs=args.epochs, extra=extra)


if __name__ == "__main__":
    main()
