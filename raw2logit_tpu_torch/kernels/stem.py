"""Fused ResNet stem (conv 7x7/2 3->64, train-mode batch norm, ReLU, maxpool
3x3/2): the five CUDA kernels of ``csrc/stem.cu``, their plain PyTorch
versions, ``StemTrain`` (the autograd function around them), ``stem_eval``
and ``stem_reference`` (the plain stem).

Port of ``raw2logit_tpu/pallas/stem.py`` (``_conv_kernel``,
``_bnpool_kernel``, ``_pool_bn_bwd_kernel``, ``_conv_dw_kernel``,
``_conv_dxs_kernel``; ``stem_train`` with its custom VJP, ``stem_eval``,
``stem_reference``). The public functions take NCHW input and OIHW
weights; the TPU kernels' space-to-depth phase planes and selector
matrices have no counterpart, since the CUDA kernels read strided taps
directly. ``stem_eval`` is differentiable where JAX's is not: its backward
runs the pool backward, dW and d_x kernels of ``StemTrain``'s, with the
running statistics held constant.

Contract: x (B, 3, H, W) and the weights (64, 3, 7, 7), both float32, H
and W multiples of 4 (the pooled plane is (H / 4, W / 4)); the JAX kernels
need H a multiple of 32. Anything else raises.

Compute dtype (JAX ``compute_dtype``): float32, or bfloat16, in which act,
pooled, d_n and the pooled cotangent are stored as bfloat16 and every
kernel runs its bfloat16 form, rounding where the JAX kernels round: x and
w on the convolutions' loads, act and d_n as stored (their sums from the
float32 values), d_a before dW and d_x contract it; BN, ReLU and the pool
compute in float32; dW, d_x and the statistics stay float32. The plain
versions round at the same points. The dtype of the planes a wrapper is
given selects the form; any other dtype raises.

Each wrapper launches its kernel on a CUDA tensor (and raises if the
launch fails) and runs its plain version on a CPU tensor; ``.launches``
counts the float32 form's launches, ``.launches_bf16`` the bfloat16
form's. The statistics, the pool backward's sums and dW are per-CTA (or
per-unit) partials summed here in float64, so two launches are bitwise
equal.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from raw2logit_tpu_torch.kernels.build import load, sm_count
from raw2logit_tpu_torch.ops.filters import conv2d_f32, full_float32
from raw2logit_tpu_torch.parallel import distributed

C_OUT, C_IN, K = 64, 3, 7
TAPS = C_IN * K * K
# the storage dtypes of act, pooled, d_n and the pooled cotangent
DTYPES = (torch.float32, torch.bfloat16)
# kernel ids of r2l_stem_tiles (csrc/stem.cu owns the tile shapes): the
# bfloat16 forms of d_x and of the conv forward walk tiles of their own
(_CONV_FWD, _POOL_BWD, _CONV_DW, _CONV_DX, _CONV_DX_BF16,
 _CONV_FWD_BF16) = range(6)


# --------------------------------------------------------------------------
# plain versions


# The plain versions compute in their inputs' dtype (float32, or float64
# for a witness); a bfloat16 form widens its bfloat16 planes to float32,
# rounds where the kernels round and stores bfloat16.


def rounded(t, dtype):
    """``t`` rounded to bfloat16's precision where ``dtype`` is bfloat16,
    kept in its own dtype; else ``t``."""
    return t.to(dtype).to(t.dtype) if dtype == torch.bfloat16 else t


def stored(t, dtype):
    """``t`` as a bfloat16 form stores it: bfloat16 where ``dtype`` is."""
    return t.to(dtype) if dtype == torch.bfloat16 else t


def widened(t):
    """A bfloat16 plane as float32; any other as it is."""
    return t.float() if t.dtype == torch.bfloat16 else t


def stem_conv_reference(x, w, stats=True, dtype=torch.float32):
    """act = conv(x, w), stride 2, pad 3, in full float32 (float64 on
    float64 inputs) on x and w rounded to ``dtype``, stored as ``dtype``;
    and, with ``stats``, the per-channel float64 sums of the unrounded act
    and act^2 (else None, None)."""
    act = conv2d_f32(rounded(x, dtype), rounded(w, dtype), stride=2,
                     padding=3)
    if not stats:
        return stored(act, dtype), None, None
    a = act.double()
    return stored(act, dtype), a.sum((0, 2, 3)), (a * a).sum((0, 2, 3))


def _per_channel(v):
    return v[:, None, None]


def stem_bnpool_reference(act, alpha, beta):
    """maxpool 3x3/2 pad 1 of relu(act * alpha + beta), per channel (a
    bfloat16 act widened to float32, the result stored bfloat16)."""
    n = widened(act) * _per_channel(alpha) + _per_channel(beta)
    return stored(F.max_pool2d(F.relu(n), 3, 2, padding=1), act.dtype)


def window_taps(r):
    """(9, B, C, Ho/2, Wo/2): tap t = (dy, dx) row-major of pooling window
    (i, j) is r[2i + dy - 1, 2j + dx - 1], -1 outside the plane."""
    hq, wq = r.shape[2] // 2, r.shape[3] // 2
    rp = F.pad(r, (1, 1, 1, 1), value=-1.0)
    return torch.stack([rp[:, :, dy:dy + 2 * hq:2, dx:dx + 2 * wq:2]
                        for dy in range(3) for dx in range(3)])


def stem_pool_bwd_reference(act, d_pooled, alpha, beta, mean, inv):
    """Pool, ReLU and BN backward: d_n (the cotangent of n = act * alpha +
    beta) and the per-channel float64 sums of d_n and d_n * xhat, with
    xhat = (act - mean) * inv. Each pooling window hands its cotangent to
    its first maximum in tap order (``_argmax_first`` of the JAX
    package); positions sum what they receive in tap order. A bfloat16
    form computes in float32 on act and d_pooled widened and returns d_n
    bfloat16, its sums those of the float32 d_n."""
    dtype = act.dtype
    act, d_pooled = widened(act), widened(d_pooled)
    n = act * _per_channel(alpha) + _per_channel(beta)
    taps = window_taps(F.relu(n))
    best = taps.max(0).values
    first = torch.full(best.shape, 9, dtype=torch.int64, device=act.device)
    for t in reversed(range(9)):
        first = torch.where(taps[t] == best, t, first)
    hq, wq = best.shape[2:]
    d_r = torch.zeros(n.shape[:2] + (n.shape[2] + 2, n.shape[3] + 2),
                      dtype=act.dtype, device=act.device)
    for t in range(9):
        dy, dx = divmod(t, 3)
        d_r[:, :, dy:dy + 2 * hq:2, dx:dx + 2 * wq:2] += torch.where(
            first == t, d_pooled, 0.0)
    d_n = torch.where(n > 0, d_r[:, :, 1:-1, 1:-1], 0.0)
    xhat = (act - _per_channel(mean)) * _per_channel(inv)
    d64 = d_n.double()
    return (stored(d_n, dtype), d64.sum((0, 2, 3)),
            (d64 * xhat.double()).sum((0, 2, 3)))


def bn_input_cotangent(act, d_n, coef):
    """d_a = g1 (d_n - c1 - xhat c2), xhat = (act - mu) inv: the
    train-mode batch norm's input cotangent, from coef = (g1, c1, c2, mu,
    inv), each (64,)."""
    g1, c1, c2, mu, inv = (_per_channel(v) for v in coef)
    xhat = (act - mu) * inv
    return g1 * ((d_n - c1) - xhat * c2)


def _conv_cotangent(act, d_n, coef):
    """d_a from act and d_n (bfloat16 ones widened, and d_a rounded to
    bfloat16)."""
    return rounded(bn_input_cotangent(widened(act), widened(d_n), coef),
                   act.dtype)


def stem_conv_dw_reference(x, act, d_n, coef):
    """dW (64, 3, 7, 7) of the conv for the cotangent d_a (with a bfloat16
    act, x and d_a rounded to bfloat16 and dW float32)."""
    d_a = _conv_cotangent(act, d_n, coef)
    with full_float32():
        return torch.nn.grad.conv2d_weight(rounded(x, act.dtype),
                                           (C_OUT, C_IN, K, K), d_a,
                                           stride=2, padding=3)


def stem_conv_dx_reference(act, d_n, coef, w):
    """d_x (B, 3, 2 Ho, 2 Wo) of the conv for the cotangent d_a (with a
    bfloat16 act, d_a and w rounded to bfloat16 and d_x float32)."""
    d_a = _conv_cotangent(act, d_n, coef)
    b, _, ho, wo = act.shape
    with full_float32():
        return torch.nn.grad.conv2d_input((b, C_IN, 2 * ho, 2 * wo),
                                          rounded(w, act.dtype), d_a,
                                          stride=2, padding=3)


def stem_reference(x, w, gamma, beta, mean, var, train, eps=1e-5,
                   momentum=0.9):
    """The plain stem, differentiable by autograd in the inputs' dtype:
    conv, batch norm (batch statistics with the biased variance in train
    mode, else ``mean`` and ``var``), ReLU, maxpool. Returns (pooled, the
    running mean and variance after flax's update r <- momentum r + (1 -
    momentum) batch)."""
    y = conv2d_f32(x, w, stride=2, padding=3)
    if train:
        bm = y.mean((0, 2, 3))
        bv = y.var((0, 2, 3), unbiased=False)
        new_mean = momentum * mean + (1 - momentum) * bm.detach()
        new_var = momentum * var + (1 - momentum) * bv.detach()
    else:
        bm, bv, new_mean, new_var = mean, var, mean, var
    yn = ((y - _per_channel(bm)) * _per_channel(torch.rsqrt(bv + eps))
          * _per_channel(gamma) + _per_channel(beta))
    return F.max_pool2d(F.relu(yn), 3, 2, padding=1), new_mean, new_var


# --------------------------------------------------------------------------
# input checks


def _check_float32(name, t):
    if t.dtype != torch.float32:
        raise NotImplementedError(f"the stem kernels compute in float32; got "
                                  f"a {t.dtype} {name}")


def _check_x_shape(shape):
    if len(shape) != 4 or shape[1] != C_IN:
        raise ValueError(f"the stem kernels take (B, 3, H, W), got "
                         f"{tuple(shape)}")
    b, _, h, wd = shape
    if b < 1 or h < 4 or wd < 4 or h % 4 or wd % 4:
        raise ValueError(f"the stem kernels need B >= 1 and H, W multiples "
                         f"of 4, got {tuple(shape)}")


def _check_w(w):
    _check_float32("conv weight", w)
    if tuple(w.shape) != (C_OUT, C_IN, K, K):
        raise NotImplementedError(
            f"the stem kernels take a (64, 3, 7, 7) conv weight, got "
            f"{tuple(w.shape)}")


def check_stem_input(x, w):
    """Raise unless x is (B, 3, H, W) float32 with H, W multiples of 4 and
    w is (64, 3, 7, 7) float32 on x's device."""
    _check_float32("input", x)
    _check_w(w)
    _check_x_shape(x.shape)
    if w.device != x.device:
        raise ValueError(f"conv weight on {w.device}, input on {x.device}")


def _check_dtype(dtype):
    if dtype not in DTYPES:
        raise NotImplementedError(f"the stem kernels compute in float32 or "
                                  f"bfloat16, got {dtype}")


def _storage(*planes):
    """The one storage dtype (float32 or bfloat16) of act, d_n and the
    pooled cotangent; raises on another or on a mix."""
    dtypes = {t.dtype for t in planes}
    if len(dtypes) != 1:
        raise ValueError(f"the stem planes must share a dtype, got "
                         f"{sorted(map(str, dtypes))}")
    dtype = dtypes.pop()
    _check_dtype(dtype)
    return dtype


def _on_cuda(planes, floats):
    """True when every tensor is a contiguous CUDA tensor on one device,
    False when all are on the CPU; raises otherwise. ``planes`` share a
    storage dtype (``_storage``), ``floats`` (x, w, the BN coefficients)
    are float32."""
    for t in floats:
        _check_float32("operand", t)
    tensors = tuple(planes) + tuple(floats)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return False
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the stem kernels run on one cuda device or the "
                         f"cpu, got {sorted(map(str, devices))}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the stem kernels need contiguous tensors")
    return True


def _count(fn, dtype):
    """One launch of ``fn``'s kernel in its ``dtype`` form."""
    if dtype == torch.float32:
        fn.launches += 1
    else:
        fn.launches_bf16 += 1


def _check_plane(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"stem {name}: expected {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def _coef(rows):
    return torch.stack([r.detach().reshape(C_OUT) for r in rows]).contiguous()


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.r2l_cuda_error_string(rc).decode())


def _bf16(dtype):
    """The C interface's form flag: 1 for the bfloat16 form."""
    return int(dtype == torch.bfloat16)


def _ctas(lib, kernel, device, shape):
    """Grid of a kernel that walks the tiles (or, the pool backward, the
    units) of input ``shape`` (B, 3, H, W) with a persistent grid
    (``r2l_stem_ctas``). A function of the shape and the card only, so
    repeated launches are bitwise equal."""
    b, _, h, w = shape
    return lib.r2l_stem_ctas(kernel, b, h, w, sm_count(device.index or 0))


# --------------------------------------------------------------------------
# kernel wrappers


def stem_conv(x, w, stats=True, dtype=torch.float32):
    """(act (B, 64, H/2, W/2) in ``dtype``, float64 sum of act, float64 sum
    of act^2) per channel; the sums are None without ``stats``. Kernel:
    CUDA ``stem_conv_fwd_kernel`` on FMA units for float32, bound by
    operations; for bfloat16 ``stem_conv_fwd_mma_kernel`` on bf16 tensor
    cores, bound by bytes: the 64 channels by 8-position tiles by (c, ky)
    rows of 8 taps, 11 k16 steps chained in the tensor core, act rounded
    to bfloat16 and the sums taken from the float32 accumulators. The
    partials (a row per CTA) are summed here in float64. Plain:
    ``stem_conv_reference``."""
    check_stem_input(x, w)
    _check_dtype(dtype)
    if not _on_cuda((), (x, w)):
        return stem_conv_reference(x, w, stats, dtype)
    b, _, h, wd = x.shape
    act = torch.empty((b, C_OUT, h // 2, wd // 2), dtype=dtype,
                      device=x.device)
    lib = _library()
    ctas = _ctas(lib, _CONV_FWD_BF16 if dtype == torch.bfloat16
                 else _CONV_FWD, x.device, x.shape)
    partials = (torch.empty((ctas, 2, C_OUT), dtype=torch.float64,
                            device=x.device) if stats else None)
    rc = lib.r2l_stem_conv_fwd(
        x.data_ptr(), w.data_ptr(), act.data_ptr(),
        None if partials is None else partials.data_ptr(), b, h, wd, ctas,
        _bf16(dtype), _stream(x))
    _raise_on(lib, rc, "stem_conv_fwd")
    _count(stem_conv, dtype)
    if not stats:
        return act, None, None
    sums = partials.sum(0)
    return act, sums[0], sums[1]


stem_conv.launches = stem_conv.launches_bf16 = 0


def stem_bnpool(act, alpha, beta):
    """maxpool 3x3/2 pad 1 of relu(act * alpha + beta): (B, 64, Ho/2,
    Wo/2) in act's dtype. Kernel: CUDA ``stem_bnpool_kernel`` (a thread a
    pooled element) for float32; for bfloat16 ``stem_bnpool_strip_kernel``,
    warps walking 128-column strips of the planes, r formed once per
    element; both bound by bytes. Plain: ``stem_bnpool_reference``."""
    b, c, ho, wo = act.shape
    if c != C_OUT or ho % 2 or wo % 2:
        raise ValueError(f"stem_bnpool takes (B, 64, Ho, Wo) with Ho, Wo "
                         f"even, got {tuple(act.shape)}")
    dtype = _storage(act)
    if not _on_cuda((act,), (alpha, beta)):
        return stem_bnpool_reference(act, alpha, beta)
    out = torch.empty((b, C_OUT, ho // 2, wo // 2), dtype=dtype,
                      device=act.device)
    coef = _coef((alpha, beta))
    lib = _library()
    rc = lib.r2l_stem_bnpool(act.data_ptr(), coef.data_ptr(), out.data_ptr(),
                             b, ho, wo, _bf16(dtype), _stream(act))
    _raise_on(lib, rc, "stem_bnpool")
    _count(stem_bnpool, dtype)
    return out


stem_bnpool.launches = stem_bnpool.launches_bf16 = 0


def stem_pool_bwd(act, d_pooled, alpha, beta, mean, inv):
    """(d_n in act's dtype, float64 sum of d_n, float64 sum of d_n * xhat)
    per channel. Kernel: CUDA ``stem_pool_bwd_kernel``; plain:
    ``stem_pool_bwd_reference``."""
    b, c, ho, wo = act.shape
    if c != C_OUT or ho % 2 or wo % 2:
        raise ValueError(f"stem_pool_bwd takes act (B, 64, Ho, Wo) with Ho, "
                         f"Wo even, got {tuple(act.shape)}")
    _check_plane("pooled cotangent", d_pooled, (b, C_OUT, ho // 2, wo // 2))
    dtype = _storage(act, d_pooled)
    if not _on_cuda((act, d_pooled), (alpha, beta, mean, inv)):
        return stem_pool_bwd_reference(act, d_pooled, alpha, beta, mean, inv)
    lib = _library()
    x_shape = (b, C_IN, 2 * ho, 2 * wo)
    d_n = torch.empty_like(act)
    # one float64 pair per unit of the kernel's walk
    partials = torch.empty(
        (b, C_OUT, lib.r2l_stem_tiles(_POOL_BWD, 2 * ho, 2 * wo), 2),
        dtype=torch.float64, device=act.device)
    coef = _coef((alpha, beta, mean, inv))
    rc = lib.r2l_stem_pool_bwd(act.data_ptr(), d_pooled.data_ptr(),
                               coef.data_ptr(), d_n.data_ptr(),
                               partials.data_ptr(), b, ho, wo,
                               _ctas(lib, _POOL_BWD, act.device, x_shape),
                               _bf16(dtype), _stream(act))
    _raise_on(lib, rc, "stem_pool_bwd")
    _count(stem_pool_bwd, dtype)
    sums = partials.sum((0, 2))
    return d_n, sums[:, 0], sums[:, 1]


stem_pool_bwd.launches = stem_pool_bwd.launches_bf16 = 0


def _check_bwd(x_shape, act, d_n):
    b, _, h, wd = x_shape
    _check_plane("act", act, (b, C_OUT, h // 2, wd // 2))
    _check_plane("d_n", d_n, act.shape)
    return _storage(act, d_n)


def stem_conv_dw(x, act, d_n, coef):
    """dW (64, 3, 7, 7), float32, for d_a = ``bn_input_cotangent(act, d_n,
    coef)`` (x and d_a rounded to act's dtype). Kernel: CUDA
    ``stem_conv_dw_kernel`` on FMA units for float32 (a row of partials per
    CTA and half of it); for bfloat16 ``stem_conv_dw_mma_kernel`` on bf16
    tensor cores (a row per CTA), bound by bytes: each k16 step of 16
    positions is one MMA with a fresh accumulator added into float32 sums,
    and, where the tensor core's truncation would show (at most 4096
    positions), rounded to nearest by a second MMA, so that dW stays as
    near float64 as the plain version. The partials are summed here in
    float64. Plain: ``stem_conv_dw_reference``."""
    _check_float32("input", x)
    _check_x_shape(x.shape)
    dtype = _check_bwd(x.shape, act, d_n)
    if not _on_cuda((act, d_n), (x, *coef)):
        return stem_conv_dw_reference(x, act, d_n, coef)
    b, _, h, wd = x.shape
    lib = _library()
    ctas = _ctas(lib, _CONV_DW, x.device, x.shape)
    rows = ctas if dtype == torch.bfloat16 else 2 * ctas
    partials = torch.empty((rows, C_OUT * TAPS), dtype=torch.float32,
                           device=x.device)
    cf = _coef(coef)
    rc = lib.r2l_stem_conv_dw(x.data_ptr(), act.data_ptr(), d_n.data_ptr(),
                              cf.data_ptr(), partials.data_ptr(), b, h, wd,
                              ctas, _bf16(dtype), _stream(x))
    _raise_on(lib, rc, "stem_conv_dw")
    _count(stem_conv_dw, dtype)
    return (partials.double().sum(0).float()
            .reshape(C_OUT, C_IN, K, K))


stem_conv_dw.launches = stem_conv_dw.launches_bf16 = 0


def stem_conv_dx(act, d_n, coef, w):
    """d_x (B, 3, 2 Ho, 2 Wo), float32, for d_a = ``bn_input_cotangent(act,
    d_n, coef)`` (d_a and w rounded to act's dtype). Kernel: CUDA
    ``stem_conv_dx_kernel`` on FMA units for float32; for bfloat16
    ``stem_conv_dx_mma_kernel`` on bf16 tensor cores, bound by bytes: an
    implicit GEMM of the space-to-depth form, the four taps of a tap
    column (a k16 step of 16 channels each) chained in the tensor core,
    then added into float32 sums. Plain: ``stem_conv_dx_reference``."""
    b, _, ho, wo = act.shape
    x_shape = (b, C_IN, 2 * ho, 2 * wo)
    _check_w(w)
    _check_x_shape(x_shape)
    dtype = _check_bwd(x_shape, act, d_n)
    if not _on_cuda((act, d_n), (w, *coef)):
        return stem_conv_dx_reference(act, d_n, coef, w)
    d_x = torch.empty(x_shape, dtype=torch.float32, device=act.device)
    lib = _library()
    cf = _coef(coef)
    kernel = _CONV_DX_BF16 if dtype == torch.bfloat16 else _CONV_DX
    rc = lib.r2l_stem_conv_dx(act.data_ptr(), d_n.data_ptr(), cf.data_ptr(),
                              w.data_ptr(), d_x.data_ptr(), b, 2 * ho,
                              2 * wo, _ctas(lib, kernel, act.device, x_shape),
                              _bf16(dtype), _stream(act))
    _raise_on(lib, rc, "stem_conv_dx")
    _count(stem_conv_dx, dtype)
    return d_x


stem_conv_dx.launches = stem_conv_dx.launches_bf16 = 0


# --------------------------------------------------------------------------
# the stem


def batch_stats(s1, s2, n):
    """(mean, biased variance) in float32 from the float64 per-channel
    sums of act and act^2 over n positions: the one-pass E[act^2] -
    E[act]^2, clamped at 0, as JAX ``stem_train``."""
    mean = s1 / n
    return mean.float(), (s2 / n - mean * mean).clamp_min(0.0).float()


def bn_fold(gamma, beta, mean, var, eps=1e-5):
    """(inv, alpha, beta - mean alpha) of a batch norm with these
    statistics: n = act * alpha + (beta - mean alpha)."""
    inv = torch.rsqrt(var + eps)
    alpha = gamma * inv
    return inv, alpha, beta - mean * alpha


def bn_backward_coef(gamma, mean, inv, sd, sdx, n):
    """``coef`` (g1, c1, c2, mu, inv) of ``bn_input_cotangent`` from the
    pool backward's float64 sums sd = sum d_n and sdx = sum d_n xhat over
    n positions."""
    return gamma * inv, (sd / n).float(), (sdx / n).float(), mean, inv


class StemTrain(torch.autograd.Function):
    """``apply(x, w, gamma, beta, eps[, dtype])`` -> (pooled in ``dtype``,
    batch mean, batch variance): the train-mode stem (JAX ``stem_train``
    and its VJP, ``compute_dtype=dtype``). The forward runs the conv and
    BN-pool kernels; the variance is the biased one-pass E[act^2] -
    E[act]^2 in float64. The backward runs the pool backward, dW and (when
    x needs a gradient) d_x kernels, with dgamma = sum d_n xhat and dbeta =
    sum d_n; d_x and dW are float32. The batch statistics get no
    gradient (they feed only the running-statistics update). Under a
    process group the float64 sums of the conv forward and of the pool
    backward are summed over the ranks before they make the statistics
    and the cotangent's coefficients (dgamma and dbeta stay this rank's
    share, which the gradient all-reduce adds up)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps, dtype=torch.float32):
        act, s1, s2 = stem_conv(x, w, dtype=dtype)
        n = act.numel() // C_OUT
        if distributed.active():  # the global batch's statistics
            tot = distributed.all_reduce_(torch.cat([s1, s2, s1.new_full(
                (1,), n)]))
            s1, s2, n = tot[:C_OUT], tot[C_OUT:2 * C_OUT], tot[-1]
        mean, var = batch_stats(s1, s2, n)
        inv, alpha, shift = bn_fold(gamma, beta, mean, var, eps)
        pooled = stem_bnpool(act, alpha, shift)
        ctx.save_for_backward(x, w, act, gamma, alpha, shift, mean, inv)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, d_pooled, _d_mean, _d_var):
        x, w, act, gamma, alpha, shift, mean, inv = ctx.saved_tensors
        d_n, sd, sdx = stem_pool_bwd(act, d_pooled.contiguous(), alpha, shift,
                                     mean, inv)
        gsd, gsdx = sd, sdx  # dgamma and dbeta keep this rank's share
        if distributed.active():
            tot = distributed.all_reduce_(torch.cat([sd, sdx]))
            gsd, gsdx = tot[:C_OUT], tot[C_OUT:]
        coef = bn_backward_coef(gamma, mean, inv, gsd, gsdx, ctx.n)
        need_x, need_w, need_g, need_b = ctx.needs_input_grad[:4]
        d_w = stem_conv_dw(x, act, d_n, coef) if need_w else None
        d_x = stem_conv_dx(act, d_n, coef, w) if need_x else None
        grads = (d_x, d_w, sdx.float() if need_g else None,
                 sd.float() if need_b else None, None, None)
        return grads[:len(ctx.needs_input_grad)]  # dtype may be left out


def stem_train(x, w, gamma, beta, eps=1e-5, dtype=torch.float32):
    """Train-mode fused stem: x (B, 3, H, W) -> (pooled (B, 64, H/4, W/4) in
    ``dtype``, batch mean, biased batch variance), differentiable in x, w,
    gamma and beta (``StemTrain``)."""
    check_stem_input(x, w)
    _check_dtype(dtype)
    return StemTrain.apply(x.contiguous(), w.contiguous(), gamma, beta, eps,
                           dtype)


class _StemEval(torch.autograd.Function):
    """``apply(x, w, gamma, beta, mean, var, eps, dtype, grad)`` -> pooled
    in ``dtype``: the eval-mode stem, the batch norm folded with the
    running statistics ``mean`` and ``var``. The forward runs the conv
    (without statistics) and BN-pool kernels and, where ``grad`` (grad
    mode was on at the call) and an input needs a gradient, saves what
    the backward reads (x only where w needs one); otherwise nothing.

    The backward runs the same kernels as ``StemTrain``'s. The pool
    backward rebuilds n = act alpha + shift from the folded statistics,
    so its d_n is the eval-mode one, and its sums are dbeta = sum d_n and
    dgamma = sum d_n xhat, xhat = (act - mean) inv. The running
    statistics are constants, so the batch norm's input cotangent is d_a
    = gamma inv d_n: ``bn_input_cotangent`` with coef = (gamma inv, 0, 0,
    mean, inv), which the d_x (where x needs a gradient) and dW (where w
    does) kernels take unchanged. The statistics get no gradient, and
    nothing is summed over a process group: in eval mode each rank's
    statistics are its own (dgamma and dbeta are this rank's share, as in
    ``StemTrain``). JAX's ``stem_eval`` has no backward."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, mean, var, eps, dtype, grad):
        act, _, _ = stem_conv(x, w, stats=False, dtype=dtype)
        inv, alpha, shift = bn_fold(gamma, beta, mean, var, eps)
        if grad and any(ctx.needs_input_grad[:4]):
            ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w,
                                  act, alpha, shift, mean, inv)
        return stem_bnpool(act, alpha, shift)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_pooled):
        x, w, act, alpha, shift, mean, inv = ctx.saved_tensors
        d_n, sd, sdx = stem_pool_bwd(act, d_pooled.contiguous(), alpha, shift,
                                     mean, inv)
        zero = torch.zeros_like(inv)
        coef = (alpha, zero, zero, mean, inv)
        need_x, need_w, need_g, need_b = ctx.needs_input_grad[:4]
        d_w = stem_conv_dw(x, act, d_n, coef) if need_w else None
        d_x = stem_conv_dx(act, d_n, coef, w) if need_x else None
        return (d_x, d_w, sdx.float() if need_g else None,
                sd.float() if need_b else None, None, None, None, None, None)


def stem_eval(x, w, gamma, beta, mean, var, eps=1e-5, dtype=torch.float32):
    """Eval-mode fused stem, the batch norm folded with the running
    statistics: x (B, 3, H, W) -> (B, 64, H/4, W/4) in ``dtype``,
    differentiable in x, w, gamma and beta (``_StemEval``: the pool
    backward, d_x and dW kernels, as ``stem_train``'s backward, with the
    statistics held constant). Under ``no_grad`` it keeps nothing for a
    backward."""
    check_stem_input(x, w)
    _check_dtype(dtype)
    return _StemEval.apply(x.contiguous(), w.contiguous(), gamma, beta, mean,
                           var, eps, dtype, torch.is_grad_enabled())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _library():
    lib = load("stem")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.r2l_stem_conv_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                      i32, ptr]
    lib.r2l_stem_bnpool.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.r2l_stem_pool_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                      i32, i32, ptr]
    lib.r2l_stem_conv_dw.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, ptr]
    lib.r2l_stem_conv_dx.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                                     i32, i32, ptr]
    lib.r2l_stem_tiles.argtypes = [i32, i32, i32]
    lib.r2l_stem_ctas.argtypes = [i32, i32, i32, i32, i32]
    for fn in (lib.r2l_stem_conv_fwd, lib.r2l_stem_bnpool,
               lib.r2l_stem_pool_bwd, lib.r2l_stem_conv_dw,
               lib.r2l_stem_conv_dx, lib.r2l_stem_tiles, lib.r2l_stem_ctas):
        fn.restype = i32
    lib.r2l_cuda_error_string.argtypes = [i32]
    lib.r2l_cuda_error_string.restype = ctypes.c_char_p
    return lib
