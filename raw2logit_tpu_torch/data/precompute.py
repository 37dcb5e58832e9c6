"""Hoisted static-ISP precompute (port of
``raw2logit_tpu/data/precompute.py``): run a deterministic pipeline over a
dataset once and reuse the result wherever it is loop-invariant.

A static pipeline is deterministic and augmentation applies after it, so
training on the cached RGB (``train.py --precompute_static``) computes
what the in-graph static path computes, with the demosaic, sharpening and
denoising out of every step.
"""

import numpy as np
import torch

from raw2logit_tpu_torch import resolve_device


def precompute_pipeline_rgb(dataset, pipeline, batch_size=16, indices=None,
                            device=None):
    """Run ``pipeline`` over the ``dataset`` images (default: all of them)
    in batches of ``batch_size`` on ``device`` (None means cuda, and raises
    when CUDA is missing). Returns float32 (N, 3, H, W) on the host,
    aligned with ``indices``.

    The last partial batch is padded with copies of its first image: the
    batch a batch-coupled denoiser (bilateral: its colour sigma is the
    batch's standard deviation) sees is then the JAX package's."""
    device = resolve_device(device)
    idxs = (list(range(len(dataset))) if indices is None else
            [int(i) for i in indices])
    batch_size = max(1, min(int(batch_size), len(idxs)))
    out = None
    for s in range(0, len(idxs), batch_size):
        chunk = idxs[s:s + batch_size]
        raw = np.stack([np.asarray(dataset[i][0], np.float32)
                        for i in chunk])
        n = raw.shape[0]
        if n < batch_size:
            raw = np.concatenate(
                [raw, np.repeat(raw[:1], batch_size - n, axis=0)], axis=0)
        with torch.no_grad():
            rgb = pipeline(torch.as_tensor(raw, device=device))[:n]
        rgb = rgb.cpu().numpy()
        if out is None:
            out = np.empty((len(idxs),) + rgb.shape[1:], np.float32)
        out[s:s + n] = rgb
    return out


class PrecomputedRGBView:
    """Dataset view yielding ``(rgb[i], label)``.

    ``rgb`` is aligned with the base dataset's indices (the output of
    :func:`precompute_pipeline_rgb` with default indices). Labels come from
    the base dataset's ``labels`` list when it has one (a synthetic
    dataset makes the image in ``__getitem__``, which reading a label must
    not pay for); other attributes (``task``, ``classes``,
    ``camera_parameters``, ``images``) are the base dataset's."""

    def __init__(self, dataset, rgb):
        self.dataset = dataset
        self.rgb = np.asarray(rgb, np.float32)
        if len(self.rgb) != len(dataset):
            raise ValueError(f"rgb rows ({len(self.rgb)}) != dataset size "
                             f"({len(dataset)})")

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        labels = getattr(self.dataset, "labels", None)
        if labels is not None:
            return self.rgb[i], labels[i]
        return self.rgb[i], self.dataset[i][1]

    def __getattr__(self, name):
        if name in ("dataset", "rgb"):  # not yet set while unpickling
            raise AttributeError(name)
        return getattr(self.dataset, name)
