"""Drift forensics (offline, synthetic; port of
``examples/drift_forensics.py``): adversarially optimise the ISP
parameters against a frozen classifier, SSIM-regularised toward the
default pipeline, and write the outcome, per target, to
``<out_dir>/forensics_<target>.json`` (``results/torch/`` by default):
the frozen classifier's baseline accuracy on the default ISP it was
trained on, the per-epoch accuracy and aux-SSIM trajectory under attack,
each ISP parameter's drift, and the constrained-best attack state.

The sign of ``aux_weight``: the aux term added to the negated task loss
is weight * SSIM(default RGB, adversarial RGB), the reference's AuxLoss.
The optimiser minimises the total, so a positive weight (the reference's
default) rewards driving SSIM down; the experiment runs with a negative
weight, a reward for staying close to the default pipeline.

The constrained-best protocol: the negated task loss is unbounded below,
so with any fixed proximity weight a long enough attack shreds the
images. The finding is the constrained optimum along the attack path:
the largest accuracy drop among epochs whose SSIM to the default
pipeline stays >= a bound (ties broken toward the larger SSIM, the
nearest destructive configuration). The attack is then re-run with the
same seed for exactly that many epochs to recover that epoch's
parameters for the drift report; the end of the attack is reported
alongside (the final_* fields).

    python -m raw2logit_tpu_torch.examples.drift_forensics \
        [--targets all gamma_correct] [--use_pallas] [--device cpu]

Extra flags pass through to the training CLI: ``--use_pallas`` runs the
attack through the fused ISP kernels and the SSIM aux kernel (and drops
the stage tracking, which runs the plain ISP), ``--device cpu`` runs on
the CPU.
"""

import argparse
import json
import os

import numpy as np

from raw2logit_tpu_torch.tracking.run import Run
from raw2logit_tpu_torch.training.train import build_parser, run_train

# per-target attack hyperparameters: 'all' includes black_level, whose
# updates shred the image within one epoch at lr 1e-2; a finer lr
# samples the high-SSIM part of the attack path at epoch granularity
PER_TARGET = {"all": {"lr": 1e-3, "epochs": 24}}


def select_epoch(baseline_acc, accs, ssims, ssim_bound):
    """Constrained-best attack epoch: among epochs whose SSIM to the
    default pipeline is >= ssim_bound, the largest accuracy drop, ties
    broken toward the largest SSIM. The 0-based epoch, or None if no
    epoch qualifies."""
    qualifying = [i for i, s in enumerate(ssims) if s >= ssim_bound]
    if not qualifying:
        return None
    return max(qualifying,
               key=lambda i: (baseline_acc - accs[i], ssims[i]))


def _flat_params(module):
    """{name: float32 array} of a processor's parameters, under the JAX
    package's names (a filter's ``.weight`` dropped)."""
    return {name.removesuffix(".weight"):
            p.detach().cpu().numpy().astype(np.float32)
            for name, p in module.named_parameters()}


def _drift(state):
    """Each ISP parameter's largest change from the reference processor,
    relative to the reference's largest magnitude, rounded to 5
    places."""
    adv_flat = _flat_params(state.processor)
    ref_flat = _flat_params(state.ref_processor)
    drift = {}
    for name in sorted(adv_flat):
        a, r = adv_flat[name], ref_flat[name]
        denom = float(np.abs(r).max()) or 1.0
        drift[name] = round(float(np.abs(a - r).max()) / denom, 5)
    return drift


def _trajectory(run, aux_weight):
    metrics = run.read_metrics()
    accs = [m["val_accuracy"] for m in metrics if "val_accuracy" in m]
    # aux loss = weight * SSIM(default RGB, adversarial RGB)
    ssims = [m["val_loss_aux"] / aux_weight for m in metrics
             if "val_loss_aux" in m]
    return accs, ssims


def run_forensics(targets=("all", "additive_layer", "gamma_correct"),
                  pre_epochs=12, adv_epochs=8, batch_size=8,
                  aux_weight=-1.0, ssim_bound=0.5, out_dir="results/torch",
                  extra=(), track=True, per_target=None,
                  reuse_pretrain=False):
    """Pretrain once (the classifier on the frozen default ISP, so the
    frozen classifier's baseline is its own training pipeline), then one
    adversarial ISP search per target, and select the constrained-best
    attack state. Returns the per-target reports (also written to
    ``out_dir``)."""
    extra = list(extra)
    if per_target is None:
        per_target = PER_TARGET

    pre = ["--dataset", "SyntheticMicroscopy", "--processing_mode",
           "parametrized", "--freeze_processor",
           "--epochs", str(pre_epochs), "--batch_size", str(batch_size),
           "--n_splits", "1", "--lr", "1e-3", "--weight_decay", "1e-3",
           "--lr_schedule", "cosine", "--augmentation", "weak",
           "--experiment_name", "forensics", "--run_name", "pretrain",
           *extra]
    clf_ckpt = os.path.join("results", "runs", "forensics", "pretrain",
                            "pretrain_0", "checkpoints", "classifier.pt")
    if reuse_pretrain and os.path.isfile(clf_ckpt):
        pre_run = Run("forensics", "pretrain").child("pretrain_0")
    else:
        pre_run = run_train(build_parser().parse_args(pre))[0]["run"]
        clf_ckpt = os.path.join(pre_run.dir, "checkpoints", "classifier.pt")
    baseline_acc = [m["val_accuracy"] for m in pre_run.read_metrics()
                    if "val_accuracy" in m][-1]
    print(f"baseline (frozen classifier on default ISP): "
          f"val_accuracy={baseline_acc:.3f}")

    # the per-stage artifacts need the stage-tracking (plain) ISP: with
    # the fused kernels they are left out, as in the JAX package
    tracking = [] if (not track or "--use_pallas" in extra) else [
        "--adv_track_differences", "--track_processing",
        "--track_processing_gradients"]

    def attack(target, run_name, epochs, lr):
        adv = ["--dataset", "SyntheticMicroscopy", "--processing_mode",
               "parametrized", "--adv_training", "--freeze_classifier",
               "--classifier_uri", clf_ckpt,
               "--adv_aux_loss", "ssim",
               "--adv_aux_weight", str(aux_weight),
               "--adv_noise_layer", "--adv_parameters", target,
               *tracking,
               "--epochs", str(epochs),
               "--batch_size", str(batch_size), "--n_splits", "1",
               "--lr", str(lr), "--experiment_name", "forensics",
               "--run_name", run_name, *extra]
        return run_train(build_parser().parse_args(adv))[0]

    reports = []
    for target in targets:
        cfg = per_target.get(target, {})
        epochs = int(cfg.get("epochs", adv_epochs))
        lr = float(cfg.get("lr", 1e-2))
        res = attack(target, f"adv_{target}", epochs, lr)
        run, state = res["run"], res["state"]
        accs, ssims = _trajectory(run, aux_weight)

        i_sel = select_epoch(baseline_acc, accs, ssims, ssim_bound)
        sel_epoch = sel_acc = sel_ssim = sel_drift = None
        replay_match = None
        if i_sel is not None:
            sel_epoch = i_sel + 1
            sel_acc, sel_ssim = float(accs[i_sel]), float(ssims[i_sel])
            if i_sel == len(accs) - 1:
                sel_state = state
            else:
                # the same seed gives the same draws and data order, so
                # stopping at epoch i_sel + 1 recovers that epoch's state
                res_sel = attack(target, f"adv_{target}_sel", sel_epoch, lr)
                sel_state = res_sel["state"]
                r_accs, r_ssims = _trajectory(res_sel["run"], aux_weight)
                replay_match = bool(abs(r_accs[-1] - sel_acc) < 1e-6
                                    and abs(r_ssims[-1] - sel_ssim) < 1e-6)
                if not replay_match:
                    print(f"[{target}] WARNING: selection replay diverged "
                          f"(traj acc/ssim {sel_acc:.4f}/{sel_ssim:.4f} vs "
                          f"replay {r_accs[-1]:.4f}/{r_ssims[-1]:.4f})")
                    sel_acc, sel_ssim = r_accs[-1], r_ssims[-1]
            sel_drift = _drift(sel_state)

        report = {
            "target": target,
            "aux_weight": aux_weight,
            "attack_lr": lr,
            "ssim_bound": ssim_bound,
            "baseline_val_accuracy": round(float(baseline_acc), 4),
            "val_accuracy_per_epoch": [round(float(a), 4) for a in accs],
            "aux_ssim_per_epoch": [round(float(s), 4) for s in ssims],
            # end-of-attack state (unconstrained dynamics)
            "final_val_accuracy": round(float(accs[-1]), 4),
            "accuracy_drop": round(float(baseline_acc - accs[-1]), 4),
            "final_aux_ssim": round(float(ssims[-1]), 4),
            "param_drift_relmax": _drift(state),
            # constrained-best state (the forensic finding)
            "selected_epoch": sel_epoch,
            "selected_val_accuracy": (None if sel_acc is None
                                      else round(sel_acc, 4)),
            "selected_accuracy_drop": (
                None if sel_acc is None
                else round(float(baseline_acc) - sel_acc, 4)),
            "selected_aux_ssim": (None if sel_ssim is None
                                  else round(sel_ssim, 4)),
            "selected_param_drift_relmax": sel_drift,
            "selection_replay_match": replay_match,
            "stage_artifacts": (os.path.join(run.dir, "results")
                                if tracking else None),
        }
        reports.append(report)
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, f"forensics_{target}.json")
        with open(out, "w") as fh:
            json.dump(report, fh, indent=2)
        if sel_epoch is None:
            print(f"[{target}] NO epoch held SSIM >= {ssim_bound}; "
                  f"end state: accuracy {baseline_acc:.3f} -> "
                  f"{accs[-1]:.3f}, SSIM {ssims[-1]:.3f} -> {out}")
        else:
            print(f"[{target}] constrained-best (epoch {sel_epoch}): "
                  f"accuracy {baseline_acc:.3f} -> {sel_acc:.3f} "
                  f"(drop {report['selected_accuracy_drop']:.3f}) at "
                  f"SSIM {sel_ssim:.3f} >= {ssim_bound}; end state "
                  f"acc {accs[-1]:.3f} / SSIM {ssims[-1]:.3f} -> {out}")
    return reports


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--targets", nargs="+",
                   default=["all", "additive_layer", "gamma_correct"])
    p.add_argument("--pre_epochs", type=int, default=12)
    p.add_argument("--adv_epochs", type=int, default=8,
                   help="attack length for targets without a PER_TARGET "
                        "entry ('all' takes 24 epochs at lr 1e-3)")
    p.add_argument("--aux_weight", type=float, default=-1.0,
                   help="weight on SSIM(default, adversarial) added to the "
                        "negated task loss; negative rewards staying close "
                        "to the default pipeline")
    p.add_argument("--ssim_bound", type=float, default=0.5,
                   help="the reported attack is the strongest epoch whose "
                        "SSIM to the default pipeline stays >= this")
    p.add_argument("--reuse_pretrain", action="store_true",
                   help="skip pretraining when the frozen classifier's "
                        "checkpoint exists")
    args, extra = p.parse_known_args(argv)
    return run_forensics(targets=args.targets, pre_epochs=args.pre_epochs,
                         adv_epochs=args.adv_epochs,
                         aux_weight=args.aux_weight,
                         ssim_bound=args.ssim_bound, extra=extra,
                         reuse_pretrain=args.reuse_pretrain)


if __name__ == "__main__":
    main()
