"""The port's CUDA kernels (the serving and training forwards, both
backward variants, ``FusedISP`` around them, and the SSIM aux kernel with
``SSIMAux``) against their plain PyTorch versions, on the card, and the
plain versions' full float32 under TF32 settings. Imports no JAX, so
that it runs where the port runs:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (BWD_F64_PARAM, RES_TOL, SSIM_GRAD_REL, SSIM_SHAPES,
                        SSIM_VALUE_REL, SSIM_WEIGHTS, VARIANT_TOL,
                        bn_cotangent, bn_like_pair, bwd_agreement,
                        kernel_tolerance, max_rel, processor, smooth_mosaics,
                        ssim_agreement, witness)
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.kernels import (
    SSIMAux, fused_isp, fused_isp_bwd, fused_isp_bwd_reference,
    fused_isp_reference, fused_isp_train, fused_isp_train_reference,
    ssim_aux_reference, ssim_aux_value_grad, unpack_grads)

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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 256, 256), (2, 250, 250),
                                   (3, 67, 45), (1, 3, 3)])
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
@pytest.mark.parametrize("shape", [(4, 256, 256), (3, 67, 45), (1, 3, 3)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("cotangent", ["positive", "bn_backward"])
@pytest.mark.parametrize("variant", ["res", "recompute"])
@pytest.mark.parametrize("shape", [(4, 256, 256), (3, 67, 45)])
def test_fused_isp_bwd_matches_plain(shape, variant, cotangent, cuda):
    """Both backward variants against autograd of the plain version on a
    smoothed input, under a positive cotangent and under the mean-zero one
    of a training-mode batch norm: chip_smoke's statistical contract
    (tests/test_pallas.py:153-159) against the float32 plain version, and
    its tight limits (BWD_TIGHT_DRAW, BWD_F64_PARAM), with chip_smoke's
    seeded ISP as in its train_kernels_vs_plain phase."""
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
    stats, ok = bwd_agreement(run, plain, witness(raw, params, g), tight=True)
    assert ok, stats


@pytest.mark.gpu
def test_fused_isp_bwd_variants_agree_and_repeat(cuda, rng):
    """Residual and recompute variants within chip_smoke.VARIANT_TOL (1e-6
    abs); two launches of the residual variant bitwise identical."""
    params = perturbed_params(cuda, rng)
    raw = torch.as_tensor(rng.uniform(0, 1, (3, 130, 97)),
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
