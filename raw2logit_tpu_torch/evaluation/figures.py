"""Figure tooling: per-epoch stage GIFs and the train/val loss scatter,
read from the local run store (the port's own copy of
``raw2logit_tpu/evaluation/figures.py``, which is numpy, imageio and
matplotlib only; both import lazily).
"""

import glob
import json
import os

import numpy as np

STEP_CHOICES = ["demosaic", "color_correct", "sharpening", "gaussian",
                "clipped", "gamma_correct", "noise", "rgb"]
MODE_CHOICES = ["processing", "gradients", "diffs"]


def make_stage_gif(run_dir, stage="gamma_correct", mode="processing",
                   out_path=None, fps=2):
    """Assemble the per-epoch PNGs of one stage into a GIF."""
    import imageio.v2 as imageio
    pattern = os.path.join(run_dir, "results", "epoch_*",
                           f"img_{mode}_*_{stage}.png")
    frames = sorted(glob.glob(pattern))
    if not frames:
        raise FileNotFoundError(f"no tracked frames match {pattern}")
    images = [imageio.imread(f) for f in frames]
    out_path = out_path or os.path.join(run_dir, f"{mode}_{stage}.gif")
    imageio.mimsave(out_path, images, fps=fps)
    return out_path


def loss_scatter(run_dir, out_path=None):
    """Train-vs-val loss scatter over epochs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    path = os.path.join(run_dir, "metrics.jsonl")
    train, val = {}, {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            if "train_loss" in rec:
                train[rec["step"]] = rec["train_loss"]
            if "val_loss" in rec:
                val[rec["step"]] = rec["val_loss"]
    steps = sorted(set(train) & set(val))
    fig, ax = plt.subplots()
    sc = ax.scatter([train[s] for s in steps], [val[s] for s in steps],
                    c=steps, cmap="viridis")
    ax.set_xlabel("train loss")
    ax.set_ylabel("val loss")
    fig.colorbar(sc, label="epoch")
    out_path = out_path or os.path.join(run_dir, "loss_scatter.png")
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def show_img(img, title="no_title", out_path=None, bins=300):
    """Image (H, W, 3) or (H, W) + per-channel histogram figure, saved
    (headless)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(img)
    fig = plt.figure(figsize=(12, 6))
    ax = fig.add_subplot(121)
    ax.imshow(np.clip(img, 0, 1) if img.ndim == 3 else img,
              cmap=None if img.ndim == 3 else "gray")
    if title != "no_title":
        ax.set_title(title)
    ax2 = fig.add_subplot(122)
    if img.ndim == 3:
        for c, color in enumerate(["red", "green", "blue"][:img.shape[-1]]):
            ax2.hist(img[..., c].ravel(), bins=bins, label=f"Channel{c+1}",
                     color=color, alpha=0.5)
        ax2.legend()
    else:
        ax2.hist(img.ravel(), bins=bins)
    ax2.set_xlabel("Intensities")
    ax2.set_ylabel("Counts")
    out_path = out_path or "results/show_img.png"
    if os.path.dirname(out_path):  # bare filename -> cwd
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
