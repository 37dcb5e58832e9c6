"""Differentiable, parametrized ISP (port of
``raw2logit_tpu/isp/parametrized.py``).

raw (B, H, W) -> (rgb (B, 3, H, W), stages dict), planar throughout. The
processing parameters (black level, white balance, CCM, gamma, sharpen,
blur and debayer kernels, optional additive layer) are learnable and
carry the reference's torch names, so a reference state dict loads with
``load_state_dict``.
"""

import torch
import torch.nn as nn

from raw2logit_tpu_torch import resolve_device
from raw2logit_tpu_torch.isp.batchnorm import TorchBatchNorm
from raw2logit_tpu_torch.kernels.fused_isp import fused_isp_autograd
from raw2logit_tpu_torch.ops import constants
from raw2logit_tpu_torch.ops.color import (colour_correction, rgb_to_yuv,
                                           white_balance, yuv_to_rgb)
from raw2logit_tpu_torch.ops.filters import conv2d_single, debayer_conv
from raw2logit_tpu_torch.ops.mosaic import pack_raw


def default_camera_params():
    """(black level, white balance, colour matrix) of the ISP's default
    camera."""
    return constants.DEFAULT_CAMERA_PARAMS


def _debayer_init():
    """OIHW (co, ci, 3, 3) kernel: K_RB / K_G / K_RB on the diagonal, zero
    cross-channel taps (all trainable)."""
    k = torch.zeros(3, 3, 3, 3)
    k[0, 0] = torch.from_numpy(constants.K_RB)
    k[1, 1] = torch.from_numpy(constants.K_G)
    k[2, 2] = torch.from_numpy(constants.K_RB)
    return k


class _Filter(nn.Module):
    """Holds a conv weight under the reference's ``<name>.weight`` key."""

    def __init__(self, weight):
        super().__init__()
        self.weight = nn.Parameter(weight)


class ParametrizedProcessing(nn.Module):
    """raw (B, H, W) -> (rgb (B, 3, H, W), stages dict).

    Args:
        camera_parameters: (black_level[4], white_balance[3],
            colour_matrix[9]) initial values of the learnable params.
        track_stages: perform the YUV->RGB->YUV round-trip after
            sharpening so that the 'sharpening' stage exists in RGB space
            (alters the numerics exactly as the reference does).
        batch_norm_output: append an affine-free torch-semantics batch norm.
        additive_layer: a learnable zero-initialised (1, 3, H, W) additive
            perturbation; needs a static ``image_size``.
        use_kernel: run the fused CUDA kernels for the pre-batch-norm
            chain whenever no stage is tracked and no tap is given (the JAX
            module's ``use_pallas``): ``kernels.fused_isp_autograd``, the
            serving kernel without autograd, else ``FusedISP`` (training
            forward + residual backward kernel). On a CPU tensor the
            wrappers run their plain versions.
        device: where the parameters live; None means cuda, and raises
            when CUDA is missing.
    """

    def __init__(self, camera_parameters=None, track_stages=False,
                 batch_norm_output=True, additive_layer=False,
                 image_size=256, use_kernel=False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.track_stages = track_stages
        self.batch_norm_output = batch_norm_output
        self.use_kernel = use_kernel
        black_level, wb, ccm = (camera_parameters
                                or constants.DEFAULT_CAMERA_PARAMS)

        def param(value):
            return nn.Parameter(torch.as_tensor(
                value, dtype=torch.float32).to(device))

        self.black_level = param(black_level)
        self.white_balance = param(torch.tensor(wb).reshape(1, 3))
        self.colour_correction = param(torch.tensor(ccm).reshape(3, 3))
        self.gamma_correct = param([2.2])
        # copies: a view of the module-level constants would let an
        # in-place update (the optimizer's, load_state_dict) write through
        # to every other instance
        self.sharpening_filter = _Filter(torch.tensor(
            constants.K_SHARP, device=device).reshape(1, 1, 3, 3))
        self.gaussian_blur = _Filter(torch.tensor(
            constants.K_BLUR, device=device).reshape(1, 1, 5, 5))
        # the debayer weight is learnable (an nn.Conv2d in the reference)
        self.debayer = _Filter(_debayer_init().to(device))
        self.additive_layer = (
            param(torch.zeros(1, 3, image_size, image_size))
            if additive_layer else None)
        self.batch_norm = (TorchBatchNorm(3, device=device)
                           if batch_norm_output else None)

    @property
    def halo_rows(self):
        """The vertical receptive radius in rows of the eval-mode chain
        (3x3 debayer, 3x3 sharpening, 5x5 blur; every other stage is
        pointwise), what ``parallel.spatial`` gives each block of rows;
        None where the output depends on the whole frame (a train-mode
        output batch norm) or on the frame's size (the additive layer)."""
        if ((self.training and self.batch_norm is not None)
                or self.additive_layer is not None):
            return None
        return 4

    def kernel_params(self):
        """The parameter dict of the fused ISP kernels (not detached)."""
        return {"black_level": self.black_level,
                "debayer": self.debayer.weight,
                "white_balance": self.white_balance,
                "colour_correction": self.colour_correction,
                "sharpening_filter": self.sharpening_filter.weight,
                "gaussian_blur": self.gaussian_blur.weight,
                "gamma_correct": self.gamma_correct}

    def forward(self, raw, taps=None):
        """``taps`` maps stage names to tensors added at that stage (their
        gradients are the stages' gradients). Train or eval mode selects
        the batch norm's statistics."""
        if raw.ndim != 3:
            raise ValueError(f"needs dims (B, H, W), got {tuple(raw.shape)}")
        stages = {}

        def stage(name, x):
            if taps is not None and name in taps:
                x = x + taps[name]
            stages[name] = x
            return x

        if self.use_kernel and not self.track_stages and taps is None:
            rgb = fused_isp_autograd(raw, self.kernel_params())
            if self.additive_layer is not None:
                rgb = rgb + self.additive_layer
            if self.batch_norm is not None:
                rgb = self.batch_norm(rgb)
            return rgb, stages

        rgb = pack_raw(raw, black_level=self.black_level, reduce_size=False)
        rgb = stage("demosaic", rgb)

        rgb = debayer_conv(rgb, self.debayer.weight)

        rgb = white_balance(rgb, self.white_balance)
        rgb = colour_correction(rgb, self.colour_correction)
        rgb = stage("color_correct", rgb)

        yuv = rgb_to_yuv(rgb)
        y = conv2d_single(yuv[:, 0], self.sharpening_filter.weight,
                          pad_mode="zero")
        yuv = torch.cat([y[:, None], yuv[:, 1:]], dim=1)

        if self.track_stages:
            # round-trip so the 'sharpening' stage is observable in RGB
            rgb = yuv_to_rgb(yuv)
            rgb = stage("sharpening", rgb)
            yuv = rgb_to_yuv(rgb)

        y = conv2d_single(yuv[:, 0], self.gaussian_blur.weight,
                          pad_mode="reflect")
        rgb = yuv_to_rgb(torch.cat([y[:, None], yuv[:, 1:]], dim=1))
        rgb = stage("gaussian", rgb)

        rgb = rgb.clamp(1e-5, 1.0)
        rgb = stage("clipped", rgb)

        rgb = torch.exp(torch.log(rgb) / self.gamma_correct)
        rgb = stage("gamma_correct", rgb)

        if self.additive_layer is not None:
            rgb = rgb + self.additive_layer
            rgb = stage("noise", rgb)

        if self.batch_norm is not None:
            rgb = self.batch_norm(rgb)

        return rgb, stages
