"""The port's CUDA kernels (the serving and training forwards, both
backward variants, ``FusedISP`` around them, the SSIM aux kernel with
``SSIMAux``, and the five stem kernels with ``StemTrain`` and the
``stem_kernel`` ResNet) against their plain PyTorch versions, on the card,
the plain versions' full float32 under TF32 settings, and the ISP's output
batch norm against nn.BatchNorm2d. Imports no JAX,
so that it runs where the port runs:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BWD_F64_PARAM, BWD_PARAM, CLF_GRAD_TOL, LOSS_TOL,
                        RES_TOL, SEED, SSIM_GRAD_REL, SSIM_SHAPES,
                        SSIM_VALUE_REL, SSIM_WEIGHTS, STATS_TOL, STEM_ACT_TOL,
                        STEM_GRAD_TOL, TRAIN_LR, VARIANT_TOL, adv_config,
                        adv_copy, adv_setup, bn_agreement, bn_cotangent,
                        bn_like_pair, bwd_agreement, grad_agreement,
                        grads_and_stats, kernel_tolerance, l2_rel, max_rel,
                        processor, smooth_mosaics, ssim_agreement,
                        step_agreement, stem_agreement, stem_input,
                        stem_params, train_copy, train_setup, witness)
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.kernels import (
    SSIMAux, batch_stats, bn_backward_coef, bn_fold, fused_isp,
    fused_isp_bwd, fused_isp_bwd_reference,
    fused_isp_reference, fused_isp_train, fused_isp_train_reference,
    ssim_aux_reference, ssim_aux_value_grad, stem_bnpool, stem_conv,
    stem_conv_dw, stem_conv_dw_reference, stem_conv_dx,
    stem_conv_dx_reference, stem_conv_reference, stem_eval, stem_pool_bwd,
    stem_train, unpack_grads)
from raw2logit_tpu_torch.models import ResNet, resnet_model
from raw2logit_tpu_torch.training import TrainConfig

STEM_FNS = (stem_conv, stem_bnpool, stem_pool_bwd, stem_conv_dw, stem_conv_dx)

# the camera of tests/test_pallas.py
MILD_CAM = (
    [0.01, 0.012, 0.011, 0.013],
    [1.5, 1.0, 1.2],
    [1.2, -0.1, -0.05, -0.08, 1.1, -0.02, -0.03, -0.1, 1.15],
)


@pytest.fixture
def cuda():
    """The CUDA device, with TF32 off for cuDNN and matmul while the test
    runs, so that the plain versions compute in full float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


# Shapes that cut the ISP forward's walk (csrc/fused_isp_fwd.cu: 32 x 64
# tiles; 3 CTAs per SM, 396 on an H100 SXM's 132 SMs, at most one per
# tile; CTA k takes the run of tiles [k n / grid, (k + 1) n / grid) over
# (b, tile row, tile col)): 16x130x260, 400 tiles, five tile rows and
# columns with ragged last ones (2 rows, 4 columns), runs of 1 and 2 tiles;
# 2x33x67, odd sides, rows that are not 16-byte aligned (4-byte copies);
# 64x256x256, 2,048 tiles, runs of 5 and 6 that hold border and interior
# tiles.
FWD_SHAPES = [(16, 130, 260), (2, 33, 67), (64, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 256, 256), (2, 250, 250),
                                   (3, 67, 45), (1, 3, 3), *FWD_SHAPES])
def test_fused_isp_matches_plain(shape, cuda, rng):
    """Non-symmetric filters, cross-channel debayer taps, dark-to-bright
    exposures; edge, corner and ragged tiles. Tolerance: 2e-5 abs plus a
    1e-6 pre-gamma rounding carried through the gamma curve's slope
    (chip_smoke.KERNEL_TOL explains why)."""
    proc = ParametrizedProcessing(camera_parameters=MILD_CAM, device=cuda)
    params = proc.kernel_params()
    with torch.no_grad():
        for p in params.values():
            p.add_(torch.as_tensor(rng.normal(0.0, 0.05, p.shape),
                                   dtype=torch.float32, device=cuda))
    raw = rng.uniform(0, 1, shape) * np.linspace(0.05, 1.0, shape[0])[
        :, None, None]
    raw = torch.as_tensor(raw, dtype=torch.float32, device=cuda)
    launches = fused_isp.launches
    with torch.no_grad():
        got = fused_isp(raw, params)
        assert fused_isp.launches == launches + 1
        want = fused_isp_reference(raw, params)
    torch.cuda.synchronize()
    assert got.shape == (shape[0], 3) + shape[1:]
    gamma = float(params["gamma_correct"].detach())
    tol = kernel_tolerance(want, gamma)
    assert bool(((got - want).abs().double() <= tol).all())


@pytest.mark.gpu
def test_fused_isp_checks_its_input(cuda):
    params = ParametrizedProcessing(device=cuda).kernel_params()
    raw = torch.rand(2, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        fused_isp(raw.double(), params)
    with pytest.raises(ValueError):
        fused_isp(raw[:, ::2], params)  # not contiguous
    with pytest.raises(ValueError):
        fused_isp(raw[:, :2], params)  # too small for the reflect pad


def perturbed_params(cuda, rng, camera=MILD_CAM):
    proc = ParametrizedProcessing(camera_parameters=camera, device=cuda)
    params = proc.kernel_params()
    with torch.no_grad():
        for p in params.values():
            p.add_(torch.as_tensor(rng.normal(0.0, 0.05, p.shape),
                                   dtype=torch.float32, device=cuda))
    return params


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 256, 256), (3, 67, 45), (1, 3, 3),
                                   *FWD_SHAPES])
def test_fused_isp_train_matches_plain(shape, cuda, rng):
    """The training forward: RGB as the serving kernel's (bitwise) and
    within the serving kernel's tolerance of the plain version; residual
    planes within chip_smoke.RES_TOL (2e-5 abs)."""
    params = perturbed_params(cuda, rng)
    raw = torch.as_tensor(rng.uniform(0, 1, shape), dtype=torch.float32,
                          device=cuda)
    launches = fused_isp_train.launches
    with torch.no_grad():
        out, res = fused_isp_train(raw, params)
        assert fused_isp_train.launches == launches + 1
        served = fused_isp(raw, params)
        want, want_res = fused_isp_train_reference(raw, params)
    torch.cuda.synchronize()
    assert res.shape == (shape[0], 5) + shape[1:]
    assert torch.equal(out, served)
    gamma = float(params["gamma_correct"].detach())
    assert bool(((out - want).abs().double()
                 <= kernel_tolerance(want, gamma)).all())
    assert float((res - want_res).abs().max()) <= RES_TOL


# Shapes that cut the backward's walk (csrc/fused_isp_bwd.cu: 32x32
# tiles; r2l_fused_isp_bwd_ctas CTAs, 2 per SM, at most one per tile, 264
# on an H100 SXM's 132 SMs; CTA k walks the run of tiles [k n / grid,
# (k + 1) n / grid); the float32 sums flushed every 8 tiles of a walk):
# 1x20x28, one ragged tile, fewer tiles than CTAs; 67x128x96, 804 tiles,
# runs of 3 and of 4 (uneven); 2x40x36, 8 tiles, every one an edge tile;
# 16x256x256, 1,024 tiles, runs of 3 and 4 that hold edge and interior
# tiles; 40x256x256, 2,560 tiles, runs of 9 and 10, a flush inside every
# walk. test_fused_isp_bwd_walk_shapes holds these counts on the card at
# hand.
WALK_SHAPES = ((1, 20, 28), (67, 128, 96), (2, 40, 36), (16, 256, 256),
               (40, 256, 256))


@pytest.mark.gpu
def test_fused_isp_bwd_walk_shapes(cuda):
    """WALK_SHAPES cut the grid that the backward launches on this card as
    their comment says."""
    from raw2logit_tpu_torch.kernels.build import sm_count
    from raw2logit_tpu_torch.kernels.fused_isp_bwd import _library
    sms = sm_count(cuda.index or 0)
    walk = {}
    for b, h, w in WALK_SHAPES:
        tiles = b * -(-h // 32) * -(-w // 32)
        walk[(b, h, w)] = (tiles,
                           _library().r2l_fused_isp_bwd_ctas(b, h, w, sms))
    tiles, ctas = walk[(1, 20, 28)]
    assert tiles == ctas == 1 < 2 * sms
    tiles, ctas = walk[(67, 128, 96)]
    assert ctas == 2 * sms and tiles > 2 * ctas and tiles % ctas
    tiles, ctas = walk[(16, 256, 256)]
    assert ctas == 2 * sms and 2 < tiles / ctas < 8
    tiles, ctas = walk[(40, 256, 256)]
    assert ctas == 2 * sms and tiles > 8 * ctas


@pytest.mark.gpu
@pytest.mark.parametrize("cotangent", ["positive", "bn_backward"])
@pytest.mark.parametrize("variant", ["res", "recompute"])
@pytest.mark.parametrize("shape", [(4, 256, 256), (3, 67, 45),
                                   *WALK_SHAPES])
def test_fused_isp_bwd_matches_plain(shape, variant, cotangent, cuda):
    """Both backward variants against autograd of the plain version on a
    smoothed input, under a positive cotangent and under the mean-zero one
    of a training-mode batch norm: chip_smoke's statistical contract
    (tests/test_pallas.py:153-159) against the float32 plain version, and
    its tight limits (BWD_TIGHT_DRAW, BWD_F64_PARAM), with chip_smoke's
    seeded ISP as in its train_kernels_vs_plain phase; at the shapes that
    cut the kernel's walk over tiles (WALK_SHAPES)."""
    params = processor(cuda, use_kernel=True, camera=MILD_CAM).kernel_params()
    raw = smooth_mosaics(shape).to(cuda)
    with torch.no_grad():
        out, res = fused_isp_train(raw, params)
    g = ((out * 0.5 + 0.1).contiguous() if cotangent == "positive"
         else bn_cotangent(out))
    with torch.no_grad():
        launches = (fused_isp_bwd.launches, fused_isp_bwd.launches_res)
        run = fused_isp_bwd(raw, params, g, res if variant == "res" else None)
        assert (fused_isp_bwd.launches, fused_isp_bwd.launches_res) == (
            (launches[0], launches[1] + 1) if variant == "res"
            else (launches[0] + 1, launches[1]))
    d_ref, scal = fused_isp_bwd_reference(raw, params, g)
    plain = d_ref, unpack_grads(scal, params)
    torch.cuda.synchronize()
    # One image gets only smooth_mosaics' darkest exposure (0.05), where
    # many outputs sit near the clip floor, outside the premise of the
    # tight limits (chip_smoke: few pixels near the floor): at 1x20x28
    # under the batch-norm cotangent d_raw reads 1.15e-5 of its scale from
    # the float32 plain version, for the first port as for this kernel
    # (bitwise the same d_raw). There both are held to the float64 witness
    # instead, no further from it than twice the float32 plain version is.
    tight = shape[0] > 1
    stats, ok = bwd_agreement(run, plain, witness(raw, params, g), tight)
    assert ok, stats
    if not tight:
        near, plain_near = stats["vs_float64"], stats["plain_vs_float64"]
        assert (near["d_raw_max_abs_err_over_scale"]
                <= 2 * plain_near["d_raw_max_abs_err_over_scale"]), stats
        assert near["param_max_rel_err"] <= max(
            BWD_F64_PARAM, 2 * plain_near["param_max_rel_err"]), stats


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 130, 97), *WALK_SHAPES,
                                   *FWD_SHAPES[:2]])
def test_fused_isp_bwd_variants_agree_and_repeat(shape, cuda, rng):
    """Residual and recompute variants within chip_smoke.VARIANT_TOL (1e-6
    abs); two launches of the residual variant bitwise identical; at the
    shapes that cut the backward's walk over tiles (WALK_SHAPES) and the
    forward's (FWD_SHAPES), whose residuals the residual variant reads."""
    params = perturbed_params(cuda, rng)
    raw = torch.as_tensor(rng.uniform(0, 1, shape),
                          dtype=torch.float32, device=cuda)
    with torch.no_grad():
        out, res = fused_isp_train(raw, params)
        g = out * 0.5 + 0.1
        d_a, g_a = fused_isp_bwd(raw, params, g, res)
        d_b, g_b = fused_isp_bwd(raw, params, g)
        d_c, g_c = fused_isp_bwd(raw, params, g, res)
    torch.cuda.synchronize()
    assert float((d_a - d_b).abs().max()) <= VARIANT_TOL
    for k in g_a:
        assert float((g_a[k] - g_b[k]).abs().max()) <= VARIANT_TOL, k
        assert torch.equal(g_a[k], g_c[k]), k
    assert torch.equal(d_a, d_c)


@pytest.mark.gpu
def test_fused_isp_autograd_reaches_every_parameter(cuda, rng):
    """With grad enabled on a CUDA tensor, every ISP parameter gets a
    gradient through the training forward and the residual backward
    kernel; under no_grad the serving kernel runs."""
    proc = ParametrizedProcessing(camera_parameters=MILD_CAM, use_kernel=True,
                                  device=cuda).train()
    raw = torch.as_tensor(rng.uniform(0, 1, (2, 64, 64)),
                          dtype=torch.float32, device=cuda)
    before = (fused_isp.launches, fused_isp_train.launches,
              fused_isp_bwd.launches_res)
    rgb, _ = proc(raw)
    rgb.square().sum().backward()
    assert (fused_isp.launches, fused_isp_train.launches,
            fused_isp_bwd.launches_res) == (before[0], before[1] + 1,
                                            before[2] + 1)
    for name, p in proc.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name
    with torch.no_grad():
        proc(raw)
    assert fused_isp.launches == before[0] + 1


@pytest.mark.gpu
def test_fused_isp_bwd_checks_its_input(cuda):
    params = ParametrizedProcessing(device=cuda).kernel_params()
    raw = torch.rand(2, 16, 16, device=cuda)
    g = torch.rand(2, 3, 16, 16, device=cuda)
    res = torch.rand(2, 5, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        fused_isp_bwd(raw, params, g.double(), res)
    with pytest.raises(ValueError):
        fused_isp_bwd(raw, params, g.transpose(2, 3), res)  # not contiguous
    with pytest.raises(ValueError):
        fused_isp_bwd(raw, params, g, res[:, :4].contiguous())
    with pytest.raises(ValueError):
        fused_isp_bwd(raw, params, g[:1].contiguous())
    with pytest.raises(TypeError):
        fused_isp_train(raw.double(), params)


@pytest.mark.gpu
@pytest.mark.parametrize("weight", SSIM_WEIGHTS)
@pytest.mark.parametrize("shape", SSIM_SHAPES, ids=str)
def test_ssim_aux_matches_plain(shape, weight, cuda):
    """The SSIM aux kernel on batch-normalised-like images with flat
    patches: chip_smoke's contract (value against the float64 plain
    version, gradient against the float32 one and no further from the
    float64 one than twice the float32 one is), two launches bitwise
    equal, one launch counted per call."""
    ref, x = (t.to(cuda) for t in bn_like_pair(shape))
    launches = ssim_aux_value_grad.launches
    stats, ok = ssim_agreement(ref, x, weight)
    assert ssim_aux_value_grad.launches == launches + 2
    assert stats["bitwise_repeat"], stats
    assert ok, stats


@pytest.mark.gpu
def test_ssim_aux_function_backward(cuda):
    """``SSIMAux``: the value is the wrapper's, the backward scales the
    saved gradient by the upstream one, and the reference gets none."""
    ref, x = (t.to(cuda) for t in bn_like_pair((3, 3, 67, 45)))
    ref.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    value = SSIMAux.apply(ref, xg, -1.0)
    (2.5 * value).backward()
    want_v, want_g = ssim_aux_value_grad(ref.detach(), x, -1.0)
    torch.cuda.synchronize()
    assert torch.equal(value.detach(), want_v)
    assert torch.equal(xg.grad, 2.5 * want_g)
    assert ref.grad is None


@pytest.mark.gpu
def test_ssim_aux_checks_its_input(cuda):
    ref, x = (t.to(cuda) for t in bn_like_pair((2, 3, 16, 16)))
    with pytest.raises(TypeError):
        ssim_aux_value_grad(ref.double(), x.double(), 1.0)
    with pytest.raises(ValueError):
        ssim_aux_value_grad(ref[:, :2].contiguous(), x[:, :2].contiguous(),
                            1.0)
    with pytest.raises(ValueError):
        ssim_aux_value_grad(ref, x.transpose(2, 3), 1.0)  # not contiguous
    with pytest.raises(ValueError):
        ssim_aux_value_grad(ref[:1], x, 1.0)


@pytest.fixture
def cuda_tf32():
    """The CUDA device with TF32 allowed for cuDNN and matmul (PyTorch's
    convolution default, and what a caller may set for matmul)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@pytest.mark.gpu
def test_plain_versions_stay_float32_under_tf32(cuda_tf32):
    """With TF32 allowed, the plain ISP (forward, and its backward on
    smooth inputs) and ``ops/ssim.py`` (value and gradient) still match
    their float64 selves at the float32 tiers: the serving kernel's
    per-pixel tolerance, the backward's BWD_F64_PARAM, and SSIM_VALUE_REL
    and SSIM_GRAD_REL. In TF32 (about 1e-3 relative) each would miss."""
    assert torch.backends.cudnn.allow_tf32
    proc = processor(cuda_tf32, use_kernel=False, camera=MILD_CAM)
    params = proc.kernel_params()
    raw = smooth_mosaics((4, 256, 256)).to(cuda_tf32)
    with torch.no_grad():
        out = fused_isp_reference(raw, params)
        out64 = fused_isp_reference(raw.double(), {
            k: v.detach().double() for k, v in params.items()})
    gamma = float(params["gamma_correct"].detach())
    assert bool(((out.double() - out64).abs()
                 <= kernel_tolerance(out64, gamma)).all())
    g = (out * 0.5 + 0.1).contiguous()
    _, scal = fused_isp_bwd_reference(raw, params, g)
    grads = unpack_grads(scal, params)
    _, grads64 = witness(raw, params, g)
    errs = {k: max_rel(grads[k].double(), grads64[k], 1e-3) for k in grads}
    assert max(errs.values()) <= BWD_F64_PARAM, errs

    ref, x = (t.to(cuda_tf32) for t in bn_like_pair((8, 3, 256, 256)))
    value, d_x = ssim_aux_reference(ref, x, 0.3)
    value64, d_x64 = ssim_aux_reference(ref, x, 0.3, torch.float64)
    assert abs(float(value) - float(value64)) <= SSIM_VALUE_REL * abs(
        float(value64))
    assert float((d_x.double() - d_x64).abs().max()) <= SSIM_GRAD_REL * float(
        d_x64.abs().max())
    assert torch.backends.cudnn.allow_tf32  # the caller's setting is back


# Shapes that cut the pool backward's walk (csrc/stem.cu, section 3:
# strips of 128 pre-pool columns, units of 8 window rows of one strip of
# one plane, the warps of an r2l_stem_ctas grid, 8 a CTA and 3 CTAs per SM,
# 3,168 on an H100 SXM's 132 SMs, each taking a run of consecutive units):
# 2x36x520, three strips (128, 128 and 4 columns) of 16-byte rows and two
# units down each (9 window rows); 1x20x524, three strips of rows 262 wide
# (4-byte copies, scalar stores); 1100x4x8, past the first port's limit of
# 1,023 images (one grid z-slice per plane), 70,400 one-unit planes, so
# runs cross planes; 64x256x256, 32,768 units of which a plane holds 8,
# runs of 10 and 11 that start and end inside planes.
# test_stem_pool_bwd_walk_shapes holds these counts on the card at hand.
POOL_BWD_SHAPES = [(2, 3, 36, 520), (1, 3, 20, 524), (1100, 3, 4, 8),
                   (64, 3, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["isp", "random"])
@pytest.mark.parametrize("shape", [(4, 3, 256, 256), (3, 3, 68, 44),
                                   (1, 3, 4, 8), (2, 3, 100, 140),
                                   *POOL_BWD_SHAPES], ids=str)
def test_stem_kernels_match_plain(shape, inputs, cuda):
    """Each stem kernel against its plain version on the same inputs
    (chip_smoke.stem_agreement: the STEM_* limits, pooled and d_n bitwise,
    dW and d_x against float64 too), random inputs with planted ties in
    the pool, two launches bitwise equal; also at the shapes that cut the
    pool backward's walk (POOL_BWD_SHAPES)."""
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, shape, inputs)
    for name, (stats, ok) in stem_agreement(x, w, gamma, beta,
                                            inputs == "random").items():
        assert ok, (name, stats)


@pytest.mark.gpu
def test_stem_pool_bwd_walk_shapes(cuda):
    """POOL_BWD_SHAPES cut the pool backward's walk on this card as their
    comment says."""
    from raw2logit_tpu_torch.kernels.build import sm_count
    from raw2logit_tpu_torch.kernels.stem import _POOL_BWD, _library
    sms, lib = sm_count(cuda.index or 0), _library()
    walk = {}
    for b, _, h, w in POOL_BWD_SHAPES:
        per_plane = lib.r2l_stem_tiles(_POOL_BWD, h, w)
        walk[h, w] = (per_plane, b * 64 * per_plane,
                      8 * lib.r2l_stem_ctas(_POOL_BWD, b, h, w, sms))
    assert walk[36, 520][0] == 3 * 2 and walk[20, 524][0] == 3
    per_plane, units, warps = walk[4, 8]
    assert per_plane == 1 and units > warps == 24 * sms
    per_plane, units, warps = walk[256, 256]
    assert per_plane == 8 and warps == 24 * sms and units % warps
    assert (units // warps) % per_plane and (units // warps + 1) % per_plane


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(32, 3, 256, 256), (3, 3, 68, 44),
                                   (1, 3, 4, 8), (2, 3, 100, 140)], ids=str)
def test_stem_conv_serving_route_matches_plain(shape, cuda):
    """``stem_conv(x, w, stats=False)``, the eval-mode stem's route (no
    statistics): act within STEM_ACT_TOL of max |plain|, bitwise the
    train-mode launch's act, one launch counted, no sums."""
    w, _, _ = stem_params(cuda)
    x = stem_input(cuda, shape, "isp")
    launches = stem_conv.launches
    act, s1, s2 = stem_conv(x, w, stats=False)
    assert stem_conv.launches == launches + 1
    assert s1 is None and s2 is None
    want, _, _ = stem_conv_reference(x, w, stats=False)
    train_act, _, _ = stem_conv(x, w)
    torch.cuda.synchronize()
    assert act.shape == want.shape
    assert max_rel(act, want) <= STEM_ACT_TOL
    assert torch.equal(act, train_act)


@pytest.mark.gpu
def test_stem_kernels_check_their_input(cuda):
    w, gamma, beta = stem_params(cuda)
    x = torch.randn(2, 3, 32, 32, device=cuda)
    with pytest.raises(NotImplementedError):
        stem_conv(x.double(), w.double())
    with pytest.raises(NotImplementedError):
        stem_conv(x, w[:32].contiguous())
    with pytest.raises(ValueError):
        stem_conv(x[..., :30].contiguous(), w)  # W not a multiple of 4
    with pytest.raises(ValueError):
        stem_conv(x.transpose(2, 3), w)  # not contiguous
    with pytest.raises(ValueError):
        stem_conv(x, w.cpu())
    act, _, _ = stem_conv(x, w)
    with pytest.raises(ValueError):
        stem_bnpool(act[:, :, :15].contiguous(), gamma, beta)
    with pytest.raises(ValueError):
        stem_pool_bwd(act, torch.zeros(2, 64, 8, 7, device=cuda), gamma,
                      beta, beta, gamma)
    coef = (gamma, beta, beta, beta, gamma)
    with pytest.raises(ValueError):
        stem_conv_dw(x, act, act[:1].contiguous(), coef)
    with pytest.raises(ValueError):
        stem_conv_dx(act, act.transpose(2, 3), coef, w)


@pytest.mark.gpu
def test_stem_kernel_resnet_reaches_its_parameters_and_input(cuda):
    """``ResNet(stem_kernel=True)`` in train mode: one launch of each stem
    kernel per forward and backward; conv1, bn1 and the input get
    gradients near the plain stem's (relative L2 within STEM_GRAD_TOL: a
    pool argmax that a rounding difference moves shifts one cotangent);
    in eval mode under no_grad only the forward kernels run, and a
    backward through it runs the three backward kernels once each."""
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(4, 3, 64, 64, device=cuda, generator=gen)
    grads = {}
    for flag in (True, False):
        model = ResNet(stage_sizes=(1, 1), device=cuda, stem_kernel=flag)
        xg = x.clone().requires_grad_(True)
        before = [fn.launches for fn in (stem_conv, stem_bnpool,
                                         stem_pool_bwd, stem_conv_dw,
                                         stem_conv_dx)]
        model.train()(xg).square().sum().backward()
        after = [fn.launches for fn in (stem_conv, stem_bnpool,
                                        stem_pool_bwd, stem_conv_dw,
                                        stem_conv_dx)]
        assert [a - b for a, b in zip(after, before)] == [int(flag)] * 5
        grads[flag] = [xg.grad, model.conv1.weight.grad,
                       model.bn1.weight.grad, model.bn1.bias.grad]
    for got, want in zip(grads[True], grads[False]):
        assert got is not None and bool(got.abs().sum() > 0)
        assert l2_rel(got, want) <= STEM_GRAD_TOL
    model.stem_kernel = True
    model.eval()
    launches = stem_conv.launches, stem_pool_bwd.launches
    with torch.no_grad():
        model(x)
    assert (stem_conv.launches, stem_pool_bwd.launches) == (
        launches[0] + 1, launches[1])
    before = [fn.launches for fn in STEM_FNS]
    model(x.clone().requires_grad_(True)).sum().backward()
    assert [fn.launches - b for fn, b in zip(STEM_FNS, before)] == [1] * 5


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["joint", "forensics"])
def test_cli_resnet_runs_the_stem_kernels(mode, cuda):
    """The ResNet-18 as the CLI builds it (``resnet_model``, no
    ``stem_kernel``) behind the fused ISP at B = 32, 256x256: a joint
    train step launches each stem kernel once; the forensics step (the
    classifier frozen in eval mode, so no dW) all but ``stem_conv_dw``.
    The step agrees with the same step on the plain stem
    (``stem_kernel=False``) within chip_smoke's flag on / off limits
    (``phase_stem_train``): the loss within LOSS_TOL, the ISP's
    gradients within BWD_PARAM, and in joint training the classifier's
    gradients within CLF_GRAD_TOL and the running statistics within
    STATS_TOL."""
    if mode == "joint":
        raw, y, proc, _ = train_setup(cuda, 32)
        cfg, copy_step = TrainConfig(lr=TRAIN_LR), train_copy
    else:
        raw, y, proc, _ = adv_setup(cuda, 32)
        cfg, copy_step = adv_config(), adv_copy
    clf = resnet_model("resnet18", fc_out_features=9, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(SEED))
    assert clf.stem_kernel is None
    runs, launched = {}, {}
    for flag in (None, False):
        p, c, state, step = copy_step(cfg, proc, clf)
        c.stem_kernel = flag
        before = [fn.launches for fn in STEM_FNS]
        loss = float(step(state, raw, y)["loss"])
        launched[flag] = [fn.launches - b for fn, b in zip(STEM_FNS, before)]
        runs[flag] = grads_and_stats(p, c), loss
    assert launched == {None: [1, 1, 1, int(mode == "joint"), 1],
                        False: [0] * 5}
    if mode == "joint":
        agree = step_agreement(runs[None], runs[False])
        assert agree["clf_grad_max_rel_err"] <= CLF_GRAD_TOL, agree
        assert agree["running_stats_max_rel_err"] <= STATS_TOL, agree
    (isp_g, clf_g, _), loss = runs[None]
    (isp_r, _, _), loss_r = runs[False]
    assert abs(loss - loss_r) <= LOSS_TOL
    assert mode == "joint" or all(g is None for g in clf_g.values())
    for name, g in isp_g.items():
        assert max_rel(g.double(), isp_r[name].double(), 1e-3) <= BWD_PARAM, \
            name


@pytest.mark.gpu
def test_stem_functions_repeat_bitwise(cuda):
    """stem_train (values and every gradient) and stem_eval: two calls on
    the same inputs are bitwise equal."""
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, (8, 3, 128, 128), "random")
    runs = []
    for _ in range(2):
        args = [t.clone().requires_grad_(True) for t in (x, w, gamma, beta)]
        pooled, mean, var = stem_train(*args)
        grads = torch.autograd.grad(pooled.square().sum(), args)
        with torch.no_grad():
            ev = stem_eval(x, w, gamma, beta, mean, var)
        runs.append([pooled, mean, var, ev, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_stem_plain_versions_stay_float32_under_tf32(cuda_tf32):
    """With TF32 allowed, the stem's plain conv, dW and d_x match their
    float64 selves to float32 rounding (in TF32 each would miss by ~1e-3)."""
    w, gamma, beta = stem_params(cuda_tf32)
    x = stem_input(cuda_tf32, (4, 3, 128, 128), "random")
    act, _, _ = stem_conv_reference(x, w)
    act64, _, _ = stem_conv_reference(x.double(), w.double())
    assert max_rel(act.double(), act64) <= 1e-5
    d_n = torch.randn_like(act)
    coef = (gamma, 0.01 * beta, 0.01 * beta, 0.1 * beta, gamma)
    coef64 = tuple(c.double() for c in coef)
    for got, want in (
            (stem_conv_dw_reference(x, act, d_n, coef),
             stem_conv_dw_reference(x.double(), act.double(), d_n.double(),
                                    coef64)),
            (stem_conv_dx_reference(act, d_n, coef, w),
             stem_conv_dx_reference(act.double(), d_n.double(), coef64,
                                    w.double()))):
        assert max_rel(got.double(), want) <= 1e-5
    assert torch.backends.cudnn.allow_tf32


# the redesigned dW and d_x: full size, and shapes that cut their tiles
# (16 x 32 and 32 x 32 positions) raggedly, 72x40 with H / 2 = 36 a
# multiple of neither tile height, 100x140 with 50 x 70 positions
STEM_BWD_SHAPES = [(256, 3, 256, 256), (3, 3, 68, 44), (1, 3, 4, 8),
                   (2, 3, 72, 40), (2, 3, 100, 140)]


def stem_bwd_inputs(cuda, shape, inputs):
    """x, w and the cotangent coefficients of dW and d_x: the stem's
    forward and pool backward kernels on ``stem_input``."""
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, shape, inputs)
    with torch.no_grad():
        act, s1, s2 = stem_conv(x, w)
        n = act.numel() // 64
        mean, var = batch_stats(s1, s2, n)
        inv, alpha, shift = bn_fold(gamma, beta, mean, var)
        gen = torch.Generator(cuda).manual_seed(0)
        dp = torch.randn((shape[0], 64, shape[2] // 4, shape[3] // 4),
                         device=cuda, generator=gen)
        d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
    return x, w, act, d_n, bn_backward_coef(gamma, mean, inv, sd, sdx, n)


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["isp", "random"])
@pytest.mark.parametrize("shape", STEM_BWD_SHAPES, ids=str)
def test_stem_backward_matches_plain(shape, inputs, cuda):
    """dW and d_x against their float32 plain versions (STEM_GRAD_TOL of
    scale) and no further from the float64 plain versions than
    STEM_F64_FACTOR times the float32 plain versions are
    (chip_smoke.grad_agreement), each launch counted once."""
    x, w, act, d_n, coef = stem_bwd_inputs(cuda, shape, inputs)
    coef64 = tuple(c.double() for c in coef)
    wit_in = act.double(), d_n.double()
    launches = stem_conv_dw.launches, stem_conv_dx.launches
    with torch.no_grad():
        dw = stem_conv_dw(x, act, d_n, coef), stem_conv_dw(x, act, d_n, coef)
        dx = (stem_conv_dx(act, d_n, coef, w),
              stem_conv_dx(act, d_n, coef, w))
        assert (stem_conv_dw.launches, stem_conv_dx.launches) == (
            launches[0] + 2, launches[1] + 2)
        for run, plain, wit in (
                (dw, stem_conv_dw_reference(x, act, d_n, coef),
                 stem_conv_dw_reference(x.double(), *wit_in, coef64)),
                (dx, stem_conv_dx_reference(act, d_n, coef, w),
                 stem_conv_dx_reference(*wit_in, coef64, w.double()))):
            stats, ok = grad_agreement(*run, plain, wit)
            assert ok, stats


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STEM_BWD_SHAPES, ids=str)
def test_stem_backward_repeats_bitwise(shape, cuda):
    """Three launches each of dW and d_x on the same inputs are bitwise
    equal: no atomics, and every sum in a fixed order."""
    x, w, act, d_n, coef = stem_bwd_inputs(cuda, shape, "random")
    with torch.no_grad():
        dws = [stem_conv_dw(x, act, d_n, coef) for _ in range(3)]
        dxs = [stem_conv_dx(act, d_n, coef, w) for _ in range(3)]
    for runs in (dws, dxs):
        assert all(torch.equal(runs[0], r) for r in runs[1:])
        assert bool(torch.isfinite(runs[0]).all())


@pytest.mark.gpu
def test_output_bn_matches_batchnorm2d_on_the_card(cuda):
    """The ISP's output batch norm on the fused ISP's output at B = 256,
    256x256, against nn.BatchNorm2d(3, affine=False) in float64: output,
    running statistics, tracked batches and input gradient
    (chip_smoke.bn_agreement, the BN_* limits)."""
    params = processor(cuda, use_kernel=True).kernel_params()
    gen = torch.Generator(cuda).manual_seed(0)
    raw = torch.rand((256, 256, 256), device=cuda, generator=gen)
    with torch.no_grad():
        x = fused_isp(raw, params)
    dy = torch.randn(x.shape, device=cuda, generator=gen)
    stats, ok = bn_agreement(x, dy)
    assert ok, stats
