"""Fused ISP backward: the CUDA kernel ``csrc/fused_isp_bwd.cu`` (with and
without the training forward's residual planes), its plain PyTorch
version, and the unpacking of the parameter gradients.

Port of ``raw2logit_tpu/pallas/fused_isp_bwd.py`` (``_bwd_kernel_res``,
``_bwd_kernel``; wrapper ``fused_isp_bwd_pallas``). Both the kernel and
the plain version produce d_raw and the same 129 parameter-gradient
scalars, in the layout of the TPU kernel's partials; ``unpack_grads``
turns them into the port's parameter layouts on either route.
"""

import ctypes
import functools

import torch

from raw2logit_tpu_torch.kernels.build import load, sm_count
from raw2logit_tpu_torch.kernels.fused_isp import (
    P_A, P_BL, P_GAMMA, P_KBLUR, P_KDEB, P_KSHARP, P_MINV, _check,
    _colour_matrices, _packed_on, _raise_on, isp_from_packed, pack_params)

# Layout of the 129 scalars (fused_isp_bwd.py:188-194).
Q_DKBLUR, Q_DKSHARP, Q_DA, Q_DKDEB, Q_DBL, Q_DGAMMA = 0, 25, 34, 43, 124, 128
N_PARTIALS = 129


def fused_isp_bwd_reference(raw, params, g, dtype=torch.float32):
    """Plain version: autograd of ``isp_from_packed`` with respect to raw
    and the 138 packed numbers, for the planar cotangent g (B, 3, H, W).
    Returns (d_raw, the 129 scalars). ``dtype`` is the precision it
    computes in, from the same float32 inputs (float64 gives a witness
    for the float32 routes)."""
    packed = pack_params(params).to(dtype).requires_grad_(True)
    x = raw.detach().to(dtype).requires_grad_(True)
    with torch.enable_grad():
        out, _ = isp_from_packed(x, packed)
        d_raw, d_packed = torch.autograd.grad(out, (x, packed), g.to(dtype))
    return d_raw, torch.cat([
        d_packed[P_KBLUR:P_GAMMA], d_packed[P_KSHARP:P_KBLUR],
        d_packed[P_A:P_MINV], d_packed[P_KDEB:P_A], d_packed[P_BL:P_KDEB],
        d_packed[P_GAMMA:]])


def unpack_grads(scal, params):
    """The 129 scalars -> gradients in the shapes of ``params`` (debayer
    OIHW). dA chains into the white balance and CCM as
    ``fused_isp_bwd_pallas`` does: with G = M_RGB2YUV^T . dA,
    dCCM = G . diag(wb) and dwb = the column sums of CCM * G (in float64,
    as ``pack_params`` combines A)."""
    m_yuv, _ = _colour_matrices(scal.device)
    gmat = m_yuv.T @ scal[Q_DA:Q_DKDEB].reshape(3, 3).to(torch.float64)
    wb = params["white_balance"].detach().to(torch.float64).reshape(3)
    ccm = params["colour_correction"].detach().to(torch.float64).reshape(3, 3)
    grads = {
        "black_level": scal[Q_DBL:Q_DGAMMA],
        "debayer": scal[Q_DKDEB:Q_DBL].reshape(3, 3, 3, 3).permute(3, 2, 0, 1),
        "white_balance": (ccm * gmat).sum(0),
        "colour_correction": gmat * wb[None, :],
        "sharpening_filter": scal[Q_DKSHARP:Q_DA],
        "gaussian_blur": scal[Q_DKBLUR:Q_DKSHARP],
        "gamma_correct": scal[Q_DGAMMA:],
    }
    return {k: v.to(params[k].dtype).reshape(params[k].shape).contiguous()
            for k, v in grads.items()}


def _check_planes(raw, g, res):
    b, h, w = raw.shape
    for name, t, ch in (("g", g, 3), ("res", res, 5)):
        if t is None:
            continue
        if t.shape != (b, ch, h, w):
            raise ValueError(f"fused_isp_bwd needs {name} {(b, ch, h, w)}, "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_isp_bwd needs float32 {name}, got "
                            f"{t.dtype}")
        if t.device != raw.device:
            raise ValueError(f"{name} on {t.device}, raw on {raw.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_isp_bwd needs a contiguous {name}")


def fused_isp_bwd(raw, params, g, res=None):
    """raw (B, H, W), parameter dict, planar cotangent g (B, 3, H, W) ->
    (d_raw (B, H, W), {name: gradient} in the parameters' layouts).

    On a CUDA tensor it launches ``csrc/fused_isp_bwd.cu``: the residual
    variant when ``res`` (B, 5, H, W) from ``fused_isp_train`` is given
    (``fused_isp_bwd.launches_res``), else the variant that recomputes the
    forward (``fused_isp_bwd.launches``), and sums its per-CTA float64
    partials here in float64, in a fixed order, rounding each sum to
    float32 once (the grid, ``r2l_fused_isp_bwd_ctas``, is a function of
    the shape and the card, so two launches are bitwise equal).
    On a CPU tensor it runs ``fused_isp_bwd_reference`` (``res`` is then
    only checked). Raises if a launch fails."""
    if raw.device.type == "cuda":
        _check(raw)
    elif raw.device.type != "cpu":
        raise ValueError(f"fused_isp_bwd runs on cuda or cpu, got "
                         f"{raw.device}")
    _check_planes(raw, g, res)
    if raw.device.type == "cpu":
        d_raw, scal = fused_isp_bwd_reference(raw, params, g)
        return d_raw, unpack_grads(scal, params)
    packed = _packed_on(raw, params)
    b, h, w = raw.shape
    d_raw = torch.empty_like(raw)
    lib = _library()
    ctas = lib.r2l_fused_isp_bwd_ctas(b, h, w,
                                      sm_count(raw.device.index or 0))
    partials = torch.empty((ctas, N_PARTIALS), dtype=torch.float64,
                           device=raw.device)
    if ctas:
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        _raise_on(lib, lib.r2l_fused_isp_bwd(
            raw.data_ptr(), g.data_ptr(),
            None if res is None else res.data_ptr(), packed.data_ptr(),
            d_raw.data_ptr(), partials.data_ptr(), b, h, w, ctas, stream),
            "fused_isp_bwd")
        if res is None:
            fused_isp_bwd.launches += 1
        else:
            fused_isp_bwd.launches_res += 1
    return d_raw, unpack_grads(partials.sum(0).float(), params)


fused_isp_bwd.launches = 0
fused_isp_bwd.launches_res = 0


@functools.cache
def _library():
    lib = load("fused_isp_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.r2l_fused_isp_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32,
                                      i32, i32, ptr]
    lib.r2l_fused_isp_bwd_ctas.argtypes = [i32, i32, i32, i32]
    lib.r2l_fused_isp_bwd_ctas.restype = i32
    lib.r2l_fused_isp_bwd.restype = i32
    lib.r2l_cuda_error_string.argtypes = [i32]
    lib.r2l_cuda_error_string.restype = ctypes.c_char_p
    return lib
