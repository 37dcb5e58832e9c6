"""SSIM aux regularizer, value and gradient in one pass: the CUDA kernel
of ``csrc/ssim_aux.cu``, its plain PyTorch version, and ``SSIMAux``, the
autograd function around it.

Port of ``raw2logit_tpu/pallas/ssim_aux.py`` (``_ssim_aux_fused_kernel``;
wrapper ``ssim_aux_value_grad``). The adversarial train step needs
``weight * SSIM(ref, x)`` and its gradient in x (the reference processor
is frozen), on planar (B, 3, H, W) float32 images.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from raw2logit_tpu_torch.kernels.build import load
from raw2logit_tpu_torch.ops.ssim import gauss_np, ssim


def ssim_aux_reference(ref, x, weight, dtype=torch.float32):
    """Plain version: (weight * SSIM(ref, x), its gradient in x) by
    autograd of ``ops.ssim.ssim`` (separable windows). ``dtype`` is the
    precision it computes in, from the same inputs (float64 gives a
    witness for the float32 routes); both results come back in it."""
    r = ref.detach().to(dtype)
    xv = x.detach().to(dtype).requires_grad_(True)
    with torch.enable_grad():
        value = weight * ssim(r, xv)
        (d_x,) = torch.autograd.grad(value, xv)
    return value.detach(), d_x


def _check(ref, x):
    if x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"ssim_aux needs planar (B, 3, H, W) images, got "
                         f"{tuple(x.shape)}")
    if ref.shape != x.shape:
        raise ValueError(f"reference {tuple(ref.shape)} and image "
                         f"{tuple(x.shape)} differ in shape")
    for name, t in (("reference", ref), ("image", x)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssim_aux needs a float32 {name}, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, image on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssim_aux needs a contiguous {name}")
    if x.shape[0] * 3 > 65535:
        raise ValueError(f"ssim_aux launches one grid row per plane; "
                         f"B={x.shape[0]} exceeds 21845")


def ssim_aux_value_grad(ref, x, weight):
    """(weight * SSIM(ref, x), d/dx of it) for planar (B, 3, H, W)
    float32 images; ``ref`` gets no gradient.

    On a CUDA tensor it launches ``csrc/ssim_aux.cu`` (and raises if the
    launch fails): the per-CTA partial sums of the SSIM map are summed
    here in float64, so the value is deterministic. On a CPU tensor it
    runs ``ssim_aux_reference``. ``ssim_aux_value_grad.launches`` counts
    kernel launches."""
    if x.device.type == "cpu":
        if ref.device.type != "cpu":
            raise ValueError(f"reference on {ref.device}, image on the CPU")
        return ssim_aux_reference(ref, x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"ssim_aux runs on cuda or cpu, got {x.device}")
    ref, x = ref.detach(), x.detach()
    _check(ref, x)
    b, _, h, w = x.shape
    n = x.numel()
    if n == 0:
        raise ValueError("ssim_aux of an empty batch has no mean")
    d_x = torch.empty_like(x)
    lib = _library()
    partials = torch.empty(lib.r2l_ssim_aux_partials(b, h, w),
                           dtype=torch.float64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.r2l_ssim_aux(ref.data_ptr(), x.data_ptr(),
                          _taps(x.device).data_ptr(), weight / n,
                          d_x.data_ptr(), partials.data_ptr(), b, h, w,
                          stream)
    if rc != 0:
        raise RuntimeError("ssim_aux launch failed: "
                           + lib.r2l_cuda_error_string(rc).decode())
    ssim_aux_value_grad.launches += 1
    value = (partials.sum() * (weight / n)).float()
    return value, d_x


ssim_aux_value_grad.launches = 0


class SSIMAux(torch.autograd.Function):
    """``apply(ref, x, weight)`` -> weight * SSIM(ref, x), a 0-dim tensor
    differentiable in x. The forward computes the value and its gradient
    together (``ssim_aux_value_grad``) and saves the gradient; the
    backward scales it. No gradient reaches the detached reference or the
    weight. Once differentiable."""

    @staticmethod
    def forward(ctx, ref, x, weight):
        value, d_x = ssim_aux_value_grad(ref, x, weight)
        ctx.save_for_backward(d_x)
        return value

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_output):
        (d_x,) = ctx.saved_tensors
        return None, grad_output * d_x, None


@functools.cache
def _taps(device):
    """The 11 gaussian taps (``ops.ssim.gauss_np``) on ``device``, copied
    there once (outside inference mode, as every cached constant)."""
    with torch.inference_mode(False):
        return torch.as_tensor(gauss_np(11), device=device)


@functools.cache
def _library():
    lib = load("ssim_aux")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.r2l_ssim_aux.argtypes = [ptr, ptr, ptr, ctypes.c_float, ptr, ptr,
                                 i32, i32, i32, ptr]
    lib.r2l_ssim_aux.restype = i32
    lib.r2l_ssim_aux_partials.argtypes = [i32, i32, i32]
    lib.r2l_ssim_aux_partials.restype = i32
    lib.r2l_cuda_error_string.argtypes = [i32]
    lib.r2l_cuda_error_string.restype = ctypes.c_char_p
    return lib
