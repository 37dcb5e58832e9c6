"""Static (not learnable) ISP with the numpy reference's semantics (port
of ``raw2logit_tpu/isp/static.py``).

Plain torch, batched, on the mosaic's device: raw (B, H, W) -> planar RGB
(B, 3, H, W), stage for stage the reference's ``processing``: black
level, demosaic, white balance, colour matrix, sharpening, denoising,
clip to [0, 1], gamma.
"""

import dataclasses
from typing import Sequence, Tuple

import torch

from raw2logit_tpu_torch.ops import denoise_extra
from raw2logit_tpu_torch.ops.color import (adjust_gamma, colour_correction,
                                           white_balance)
from raw2logit_tpu_torch.ops.demosaic import DEMOSAIC_FNS
from raw2logit_tpu_torch.ops.filters import (fft_denoise, gaussian_blur_y,
                                             median_filter_y, sharpen_y,
                                             unsharp_mask_y)
from raw2logit_tpu_torch.ops.mosaic import subtract_black_level_cfa

DEBAYER_CHOICES = ("bilinear", "malvar2004", "menon2007")
SHARPENING_CHOICES = ("sharpening_filter", "unsharp_masking")
DENOISING_CHOICES = ("gaussian_denoising", "median_denoising", "fft_denoising")

# Vertical receptive radius (rows) of each stage: bilinear's 3x3 and
# Malvar's 5x5 stencils; Menon's 5-tap directional filters, the 2-row
# shift and 5x5 window of its decision (6 rows), and six 3-tap passes of
# interpolation and refinement after it; the 3x3 sharpening stencil and unsharp
# masking's 9-tap gaussian; the 5-tap gaussian and 3x3 median. The FFT
# denoiser transforms the width and colour axes only, so it is row-local.
DEMOSAIC_HALO = {"bilinear": 1, "malvar2004": 2, "menon2007": 12}
SHARPENING_HALO = {"sharpening_filter": 1, "unsharp_masking": 4}
DENOISING_HALO = {"gaussian_denoising": 2, "median_denoising": 1,
                  "fft_denoising": 0}
UNBOUNDED_DENOISERS = ("tv_chambolle", "tv_bregman", "bilateral")


@dataclasses.dataclass(frozen=True)
class StaticPipeline:
    """The configuration triple of the reference's RawProcessingPipeline.
    Callable: raw (B, H, W) or (H, W) -> rgb (B, 3, H, W) or (3, H, W).

    The defaults are the JAX package's: the reference class's default
    denoising='gaussian' matches no branch of its dispatcher and silently
    denoises nothing; its CLI's default, 'gaussian_denoising', is used
    here. The CLI's sharpening default ('sharpening_filter') differs from
    this class's."""

    camera_parameters: Tuple[Sequence[float], Sequence[float], Sequence[float]]
    debayer: str = "bilinear"
    sharpening: str = "unsharp_masking"
    denoising: str = "gaussian_denoising"

    @property
    def halo_rows(self):
        """The pipeline's vertical receptive radius in rows (what a block
        of rows needs above and below it to come out as in the whole
        frame, ``parallel.spatial``); None for a denoiser whose output
        depends on the whole frame."""
        if self.denoising in UNBOUNDED_DENOISERS:
            return None
        return (DEMOSAIC_HALO[self.debayer]
                + SHARPENING_HALO.get(self.sharpening, 0)
                + DENOISING_HALO.get(self.denoising, 0))

    def __call__(self, raw):
        black_level, wb, ccm = self.camera_parameters
        return static_process(raw, black_level, wb, ccm,
                              debayer=self.debayer,
                              sharpening=self.sharpening,
                              denoising=self.denoising)


GAMMA = 2.2


def static_process(raw, black_level, wb, ccm, debayer="bilinear",
                   sharpening="unsharp_masking",
                   denoising="gaussian_denoising"):
    """The full static pipeline on a (B, H, W) or (H, W) mosaic (a tensor,
    or an array that becomes one on the CPU): ``camera_stage``, then
    ``filter_stage``, then gamma ``GAMMA``."""
    raw = torch.as_tensor(raw)
    single = raw.dim() == 2
    if single:
        raw = raw[None]
    img = camera_stage(raw, black_level, wb, ccm, debayer)
    img = adjust_gamma(filter_stage(img, sharpening, denoising), gamma=GAMMA)
    return img[0] if single else img


def camera_stage(raw, black_level, wb, ccm, debayer):
    """Black level, demosaic, white balance and colour matrix: (B, H, W)
    -> (B, 3, H, W)."""
    img = subtract_black_level_cfa(raw, black_level)
    img = DEMOSAIC_FNS[debayer](img)
    img = white_balance(img, wb)
    return colour_correction(img, ccm)


def filter_stage(img, sharpening, denoising):
    """Sharpening, denoising and the clip to [0, 1] of (B, 3, H, W): the
    image before gamma.

    An unknown sharpening or denoising name applies none, as in the
    reference. ``tv_bregman`` raises, as in the JAX package: the pipeline
    always runs a batch, and that denoiser takes one image."""
    if sharpening == "sharpening_filter":
        img = sharpen_y(img)
    elif sharpening == "unsharp_masking":
        img = unsharp_mask_y(img)

    if denoising == "gaussian_denoising":
        img = gaussian_blur_y(img)
    elif denoising == "median_denoising":
        img = median_filter_y(img)
    elif denoising == "fft_denoising":
        img = fft_denoise(img)
    elif denoising == "tv_chambolle":
        img = denoise_extra.denoise_tv_chambolle(img)
    elif denoising == "tv_bregman":
        img = denoise_extra.denoise_tv_bregman(img)
    elif denoising == "bilateral":
        img = denoise_extra.denoise_bilateral(img)
    return torch.clamp(img, 0.0, 1.0)
