"""Image grids of the run store (port of ``save_image_grid`` of
``raw2logit_tpu/tracking/images.py``; the per-stage tracking of the
CLI's ``--track_*`` comes with ROADMAP Queue 1 item 11)."""

import numpy as np


def save_image_grid(batch, path, nrow=8):
    """Save a batch as one PNG grid: (B, C, H, W) with C 1 or 3, or (B, H,
    W), a tensor or an array; values clipped to [0, 1], 2-pixel gaps (the
    JAX package's grid of the same images in NHWC, pixel for pixel). PIL
    is imported here only."""
    from PIL import Image
    x = np.asarray(batch.cpu() if hasattr(batch, "cpu") else batch,
                   dtype=np.float32)
    x = x[..., None] if x.ndim == 3 else np.moveaxis(x, 1, -1)
    b, h, w, c = x.shape
    ncol = min(nrow, b)
    nr = (b + ncol - 1) // ncol
    pad = 2
    grid = np.zeros((nr * (h + pad) + pad, ncol * (w + pad) + pad, c),
                    np.float32)
    for i in range(b):
        r, col = divmod(i, ncol)
        grid[pad + r * (h + pad): pad + r * (h + pad) + h,
             pad + col * (w + pad): pad + col * (w + pad) + w] = x[i]
    grid = np.clip(grid, 0.0, 1.0)
    if c == 1:
        grid = grid[..., 0]
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)
