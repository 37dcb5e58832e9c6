"""Fused raw->RGB ISP forward: the CUDA kernels of
``csrc/fused_isp_fwd.cu``, their plain PyTorch versions, and ``FusedISP``,
the autograd function that pairs the training forward with the backward
kernel of ``kernels/fused_isp_bwd.py``.

Port of ``raw2logit_tpu/pallas/fused_isp.py`` (``_isp_kernel``,
``_isp_kernel_train``, shared math ``_isp_compute``; packing
``_pack_params``; plain version ``fused_isp_reference``; custom VJP
``fused_isp``). Unlike the JAX wrapper, which transposes to NHWC, the
functions here return the planar (B, 3, H, W) RGB that the kernels write.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from raw2logit_tpu_torch.kernels.build import load
from raw2logit_tpu_torch.ops import constants
from raw2logit_tpu_torch.ops.color import (colour_correction, rgb_to_yuv,
                                           white_balance, yuv_to_rgb)
from raw2logit_tpu_torch.ops.filters import conv2d_single, debayer_conv
from raw2logit_tpu_torch.ops.mosaic import pack_raw

# The parameter dict's keys, in the order FusedISP takes the tensors.
PARAM_NAMES = ("black_level", "debayer", "white_balance", "colour_correction",
               "sharpening_filter", "gaussian_blur", "gamma_correct")
# Offsets into the packed buffer (csrc/fused_isp_common.cuh P_*).
P_BL, P_KDEB, P_A, P_MINV, P_KSHARP, P_KBLUR, P_GAMMA = (
    0, 4, 85, 94, 103, 112, 137)


def pack_params(params):
    """The kernels' parameter buffer: 138 f32 on the parameters' device,
    in the order black_level (4), debayer [tap][ci*3+co] (81),
    A = M_RGB2YUV . CCM . diag(WB) (9), M_YUV2RGB (9), sharpen (9),
    blur (25), gamma (1). A is combined in float64 and rounded once.

    ``params`` holds the port's layouts: debayer OIHW (co, ci, 3, 3),
    filters (..., k, k), white balance (1, 3) or (3,). The buffer is a
    kernel input and is detached: gradients reach the parameters through
    ``FusedISP``'s backward."""
    m_yuv, minv = _colour_matrices(params["black_level"].device)
    kdeb = params["debayer"].detach().permute(2, 3, 1, 0).reshape(81)
    wb = params["white_balance"].detach().to(torch.float64).reshape(3)
    ccm = params["colour_correction"].detach().to(torch.float64).reshape(3, 3)
    a = m_yuv @ ccm @ torch.diag(wb)
    parts = [params["black_level"].detach().reshape(4), kdeb,
             a.reshape(9), minv.reshape(9),
             params["sharpening_filter"].detach().reshape(9),
             params["gaussian_blur"].detach().reshape(25),
             params["gamma_correct"].detach().reshape(1)]
    return torch.cat([p.to(torch.float32) for p in parts]).contiguous()


@functools.cache
def _colour_matrices(device):
    """M_RGB2YUV (float64) and M_YUV2RGB (float32) on ``device``, copied
    there once: a copy from host memory on every call would stall the
    host until the device reaches it. Made outside inference mode, so
    that autograd may save them whatever mode the first caller ran in."""
    with torch.inference_mode(False):
        return (torch.as_tensor(constants.M_RGB_2_YUV, dtype=torch.float64,
                                device=device),
                torch.as_tensor(constants.M_YUV_2_RGB, device=device))


def fused_isp_reference(raw, params):
    """Plain PyTorch version: the staged composition the kernel fuses
    (``ParametrizedProcessing`` without stages, additive layer or BN).
    raw (B, H, W) -> planar RGB (B, 3, H, W)."""
    rgb = pack_raw(raw, black_level=params["black_level"], reduce_size=False)
    rgb = debayer_conv(rgb, params["debayer"])
    rgb = white_balance(rgb, params["white_balance"])
    rgb = colour_correction(rgb, params["colour_correction"])
    yuv = rgb_to_yuv(rgb)
    y = conv2d_single(yuv[:, 0], params["sharpening_filter"], pad_mode="zero")
    y = conv2d_single(y, params["gaussian_blur"], pad_mode="reflect")
    rgb = yuv_to_rgb(torch.cat([y[:, None], yuv[:, 1:]], dim=1))
    rgb = rgb.clamp(1e-5, 1.0)
    return torch.exp(torch.log(rgb) / params["gamma_correct"])


def isp_from_packed(raw, packed):
    """Plain PyTorch version as a function of the 138 packed numbers the
    kernels read (``pack_params``), differentiable in both arguments.
    raw (B, H, W) -> (planar RGB (B, 3, H, W), residuals (B, 5, H, W) =
    [deb0, deb1, deb2, s, t], the planes of the training kernel)."""
    kdeb = packed[P_KDEB:P_A].reshape(3, 3, 3, 3).permute(3, 2, 0, 1)
    a = packed[P_A:P_MINV].reshape(3, 3)
    minv = packed[P_MINV:P_KSHARP].reshape(3, 3)
    rgb = pack_raw(raw, black_level=packed[P_BL:P_KDEB], reduce_size=False)
    deb = debayer_conv(rgb, kdeb)
    yuv = colour_correction(deb, a)
    s = conv2d_single(yuv[:, 0], packed[P_KSHARP:P_KBLUR].reshape(3, 3),
                      pad_mode="zero")
    t = conv2d_single(s, packed[P_KBLUR:P_GAMMA].reshape(5, 5),
                      pad_mode="reflect")
    v = colour_correction(torch.cat([t[:, None], yuv[:, 1:]], dim=1), minv)
    out = torch.exp(torch.log(v.clamp(1e-5, 1.0)) / packed[P_GAMMA])
    return out, torch.cat([deb, s[:, None], t[:, None]], dim=1)


def fused_isp_train_reference(raw, params):
    """Plain version of the training kernel: (out, res) from the packed
    parameters."""
    return isp_from_packed(raw, pack_params(params))


def _check(raw):
    if raw.dtype != torch.float32:
        raise TypeError(f"fused_isp needs float32 raw, got {raw.dtype}")
    if raw.ndim != 3:
        raise ValueError(f"fused_isp needs raw (B, H, W), got {raw.shape}")
    _, h, w = raw.shape
    if h < 3 or w < 3:
        raise ValueError(f"fused_isp needs H, W >= 3 (reflect pad), got "
                         f"{h}x{w}")
    if not raw.is_contiguous():
        raise ValueError("fused_isp needs a contiguous raw tensor")


def _on_cuda(raw):
    """True for a CUDA tensor that passes the kernels' input checks, False
    for a CPU tensor; raises for anything else."""
    if raw.device.type == "cpu":
        return False
    if raw.device.type != "cuda":
        raise ValueError(f"fused_isp runs on cuda or cpu, got {raw.device}")
    _check(raw)
    return True


def _packed_on(raw, params):
    packed = pack_params(params)
    if packed.device != raw.device:
        raise ValueError(f"parameters on {packed.device}, raw on "
                         f"{raw.device}")
    return packed


def _raise_on(lib, rc, what):
    """Raise if a launch through ``lib`` returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.r2l_cuda_error_string(rc).decode())


def fused_isp(raw, params):
    """Serving forward: raw (B, H, W) f32 + parameter dict -> planar RGB
    (B, 3, H, W) f32, with no autograd graph through the kernel (training
    goes through ``fused_isp_autograd``).

    On a CUDA tensor it launches ``csrc/fused_isp_fwd.cu``'s serving
    kernel (and raises if the launch fails); on a CPU tensor it runs
    ``fused_isp_reference``. ``params`` is
    ``ParametrizedProcessing.kernel_params()`` (see ``pack_params``).
    ``fused_isp.launches`` counts kernel launches."""
    if not _on_cuda(raw):
        return fused_isp_reference(raw, params)
    packed = _packed_on(raw, params)
    b, h, w = raw.shape
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=raw.device)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    lib = _library()
    _raise_on(lib, lib.r2l_fused_isp_fwd(
        raw.data_ptr(), packed.data_ptr(), out.data_ptr(), b, h, w, stream),
        "fused_isp_fwd")
    fused_isp.launches += 1
    return out


fused_isp.launches = 0


def fused_isp_train(raw, params):
    """Training forward: (planar RGB (B, 3, H, W), residuals (B, 5, H, W)
    = [deb0, deb1, deb2, s, t]) for ``fused_isp_bwd``. Launches the
    training kernel on a CUDA tensor (``fused_isp_train.launches``), runs
    ``fused_isp_train_reference`` on a CPU tensor."""
    if not _on_cuda(raw):
        return fused_isp_train_reference(raw, params)
    packed = _packed_on(raw, params)
    b, h, w = raw.shape
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=raw.device)
    res = torch.empty((b, 5, h, w), dtype=torch.float32, device=raw.device)
    if b == 0:
        return out, res
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    lib = _library()
    _raise_on(lib, lib.r2l_fused_isp_fwd_train(
        raw.data_ptr(), packed.data_ptr(), out.data_ptr(), res.data_ptr(),
        b, h, w, stream), "fused_isp_fwd_train")
    fused_isp_train.launches += 1
    return out, res


fused_isp_train.launches = 0


class FusedISP(torch.autograd.Function):
    """``apply(raw, *tensors)``: raw and the seven ISP parameter tensors
    (``PARAM_NAMES`` order) -> planar RGB, differentiable in all eight.
    The training forward saves its residual planes and the backward reads
    them (the residual backward kernel), as the JAX custom VJP does; on
    the CPU the same pairing runs the plain versions. Like that VJP, it is
    once differentiable."""

    @staticmethod
    def forward(ctx, raw, *tensors):
        out, res = fused_isp_train(raw, dict(zip(PARAM_NAMES, tensors)))
        ctx.save_for_backward(raw, res, *tensors)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        from raw2logit_tpu_torch.kernels.fused_isp_bwd import fused_isp_bwd
        raw, res, *tensors = ctx.saved_tensors
        d_raw, dparams = fused_isp_bwd(raw, dict(zip(PARAM_NAMES, tensors)),
                                       g.contiguous(), res)
        grads = [d_raw] + [dparams[n] for n in PARAM_NAMES]
        return tuple(gr if need else None
                     for gr, need in zip(grads, ctx.needs_input_grad))


def fused_isp_autograd(raw, params):
    """The fused ISP where gradients may be needed: ``FusedISP`` when grad
    mode is on and raw or a parameter requires grad, else the serving
    forward ``fused_isp`` (under ``no_grad`` and ``inference_mode``)."""
    tensors = [params[n] for n in PARAM_NAMES]
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (raw, *tensors)):
        return FusedISP.apply(raw, *tensors)
    return fused_isp(raw, params)


@functools.cache
def _library():
    lib = load("fused_isp_fwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.r2l_fused_isp_fwd.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.r2l_fused_isp_fwd_train.argtypes = [ptr, ptr, ptr, ptr, i32, i32,
                                            i32, ptr]
    lib.r2l_fused_isp_fwd.restype = i32
    lib.r2l_fused_isp_fwd_train.restype = i32
    lib.r2l_cuda_error_string.argtypes = [i32]
    lib.r2l_cuda_error_string.restype = ctypes.c_char_p
    return lib
