"""The drift-synthesis cycle on synthetic data, small and offline (port
of ``examples/drift_cycle.py``): train a classifier per static ISP
pipeline (a subset of the 12-pipeline grid), evaluate every (train
pipeline, test pipeline) pair into the A/B table, render its heatmap,
and summarise the matched-pipeline against the swapped-pipeline
accuracy.

    python -m raw2logit_tpu_torch.examples.drift_cycle [--device cpu]

The table goes to ``results/torch/ABtesting/tables/`` by default. The
heatmap needs matplotlib (the CPU machine's, not the card's):
``heatmap=False`` leaves it out.
"""

import argparse
import os

from raw2logit_tpu_torch.evaluation.abtesting import (ABTesting,
                                                      ab_show_table,
                                                      pipeline_name)
from raw2logit_tpu_torch.training.train import build_parser, run_train

DEFAULT_PIPELINES = [
    ("bilinear", "sharpening_filter", "gaussian_denoising"),
    ("malvar2004", "unsharp_masking", "median_denoising"),
]
TABLE_PATH = "results/torch/ABtesting/tables/ABtable_drift_cycle.json"


def run_cycle(train_pipelines=None, epochs=2, batch_size=8,
              table_path=TABLE_PATH, device=None, test_pipelines=None,
              heatmap=True):
    """Train, tabulate, render and summarise; ``device`` is where
    training and evaluation run (None: cuda).

    ``test_pipelines`` (the table's columns, default the training
    pipelines) and ``heatmap`` are not in the JAX package's ``run_cycle``
    and are not on the command line: ``chip_smoke.py`` sets them for a
    1 x 12 table on a machine without matplotlib."""
    train_pipelines = train_pipelines or DEFAULT_PIPELINES
    extra = ["--device", str(device)] if device is not None else []

    checkpoints = {}
    valid_indices = None
    for (db, sh, dn) in train_pipelines:
        name = pipeline_name(db, sh, dn)
        argv = ["--dataset", "SyntheticMicroscopy",
                "--processing_mode", "static",
                "--sp_debayer", db, "--sp_sharpening", sh,
                "--sp_denoising", dn,
                "--epochs", str(epochs), "--batch_size", str(batch_size),
                "--n_splits", "1", "--lr", "1e-3",
                "--experiment_name", "drift_cycle",
                "--run_name", name, *extra]
        results = run_train(build_parser().parse_args(argv))
        checkpoints[name] = os.path.join(results[0]["run"].dir,
                                         "checkpoints", "classifier.pt")
        valid_indices = results[0]["valid_indices"]

    ab = ABTesting("SyntheticMicroscopy", batch_size=batch_size,
                   device=device)
    table = ab.ab_make_table(checkpoints, valid_indices, table_path,
                             test_grid=test_pipelines or train_pipelines)
    png = ab_show_table(table_path, metric="accuracy") if heatmap else None
    print(f"table -> {table_path}")
    print(f"heatmap -> {png}")

    # the drift-synthesis signal: the matched (diagonal) accuracy should
    # not be below the swapped one ('_meta' is the table's fingerprint)
    diag, off = [], []
    for k, v in table.items():
        if "__VS__" not in k:
            continue
        a, b = k.split("__VS__")
        (diag if a == b else off).append(v["accuracy_mean"])
    summary = {"matched_acc": sum(diag) / len(diag),
               "swapped_acc": (sum(off) / len(off)) if off else None,
               "table_path": table_path, "heatmap": png}
    print(f"matched-pipeline acc: {summary['matched_acc']:.3f}, "
          f"swapped-pipeline acc: {summary['swapped_acc']}")
    return summary


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without CUDA) or cpu")
    args = p.parse_args(argv)
    return run_cycle(device=args.device)


if __name__ == "__main__":
    main()
