"""Identity / mosaic-only processor, ``processing_mode='none'`` (port of
``raw2logit_tpu/isp/identity.py``): the raw -> colour-plane packing,
optionally normalised per channel. The paper's ablation baseline.
"""

import torch
import torch.nn as nn

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.ops.mosaic import pack_raw


def register_mosaic_stats(module, mean, std, device):
    """``module.mosaic_mean`` and ``mosaic_std``: the per-channel mosaic
    statistics as (C, 1, 1) buffers on ``device`` that are not saved (as
    in JAX, they are arguments, not variables), or None."""
    for name, v in (("mosaic_mean", mean), ("mosaic_std", std)):
        module.register_buffer(name, None if mean is None else torch.tensor(
            v, dtype=torch.float32, device=device).reshape(-1, 1, 1),
            persistent=False)


def normalise_mosaic(module, x):
    """(x - mean) / std with ``module``'s mosaic statistics, if any."""
    if module.mosaic_mean is None:
        return x
    return (x - module.mosaic_mean) / module.mosaic_std


class RawToRGB(nn.Module):
    """raw (B, H, W) -> (rgb, stages): the half-resolution ``pack_raw``
    planes (B, 3, H/2, W/2), then the optional normalisation. The
    ``demosaic`` stage is recorded before the normalisation, as in JAX.
    No parameters; ``device`` None means cuda. (JAX's ``reduce_size`` and
    ``out_channels``, which its CLI sets to True and 3, are constants
    here.)"""

    def __init__(self, normalize_mosaic_mean=None, normalize_mosaic_std=None,
                 device=None):
        super().__init__()
        register_mosaic_stats(self, normalize_mosaic_mean,
                              normalize_mosaic_std, resolve_device(device))

    def forward(self, raw, taps=None):
        """``taps`` as ``NNProcessing``'s (the ``demosaic`` stage only)."""
        rgb = pack_raw(raw, reduce_size=True, out_channels=3)
        if taps and "demosaic" in taps:
            rgb = rgb + taps["demosaic"]
        return normalise_mosaic(self, rgb), {"demosaic": rgb}
