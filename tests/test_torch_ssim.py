"""PyTorch port vs the JAX package: SSIM (``ops/ssim.py``), the SSIM aux
kernel's plain version (``kernels.ssim_aux_value_grad`` on the CPU) and
the autograd function ``SSIMAux``, and the full-float32 convolution
helper that keeps the port's plain convolutions out of TF32 on the card.

All on the CPU. Inputs are made with numpy and handed to both packages:
BN-normalised-like images (mean about 0, negative values) with flat
patches, where both images are near zero and D1 D2 is small. The CUDA
kernel is held to the plain version by tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.ops.ssim import _gauss_np as jax_gauss_np
from raw2logit_tpu.ops.ssim import ssim as jax_ssim
from raw2logit_tpu.pallas.ssim_aux import \
    ssim_aux_value_grad as jax_ssim_aux_value_grad

from raw2logit_tpu_torch import losses
from raw2logit_tpu_torch.kernels import (SSIMAux, ssim_aux_reference,
                                         ssim_aux_value_grad)
from raw2logit_tpu_torch.ops.filters import _Conv2dF32
from raw2logit_tpu_torch.ops.ssim import gauss_np, ssim

# tests/test_pallas.py:231-233: value 1e-6 abs, gradient 1e-8 abs at
# (2, 3, 32, 32). The gradient carries the mean's factor 1 / (B C H W), so
# at a shape of n elements the same tier is 1e-8 * 6144 / n (grad_tol).
VALUE_TOL, GRAD_TOL = 1e-6, 1e-8


def grad_tol(shape):
    return GRAD_TOL * 6144 / np.prod(shape)


# float32 SSIM of the same inputs through two frameworks' convolutions:
# value abs; gradient max-relative (the unscaled SSIM's gradient grows as
# 1 / (B C H W), to 1e-2 at the smallest shape)
SSIM_TOL, SSIM_GRAD_REL = 1e-6, 1e-5
SHAPES = [(2, 3, 32, 32), (1, 3, 13, 29), (2, 3, 5, 7)]


def bn_like_pair(shape, seed=0):
    """A reference image and an adversarial one, normalised like the ISP's
    batch-norm output (mean 0, std 1, negative values), with a flat patch
    near zero in both (D1 D2 small there)."""
    rng = np.random.default_rng((seed,) + shape)
    ref = rng.normal(0.0, 1.0, shape)
    x = ref + 0.3 * rng.normal(0.0, 1.0, shape)
    h, w = shape[2] // 2, shape[3] // 2
    ref[:, :, :h, :w] = 0.01
    x[:, :, :h, :w] = 0.012
    return ref.astype(np.float32), x.astype(np.float32)


def nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def test_gauss_taps_match_jax():
    np.testing.assert_array_equal(gauss_np(11), jax_gauss_np(11))


@pytest.mark.parametrize("separable", [True, False],
                         ids=["separable", "dense"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ssim_matches_jax(shape, separable):
    """Scalar mean and per-image mean, separable and dense windows."""
    ref, x = bn_like_pair(shape)
    t = torch.from_numpy
    got = ssim(t(ref), t(x), separable=separable)
    want = jax_ssim(nhwc(ref), nhwc(x), separable=separable)
    assert abs(float(got) - float(want)) < SSIM_TOL
    got = ssim(t(ref), t(x), size_average=False, separable=separable)
    want = jax_ssim(nhwc(ref), nhwc(x), size_average=False,
                    separable=separable)
    assert got.shape == (shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SSIM_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ssim_gradient_matches_jax(shape):
    """Autograd of the port's SSIM against jax.grad, in both images."""
    ref, x = bn_like_pair(shape, seed=1)
    a = torch.from_numpy(ref).requires_grad_(True)
    b = torch.from_numpy(x).requires_grad_(True)
    ssim(a, b).backward()
    ga, gb = jax.grad(lambda p, q: jax_ssim(p, q), argnums=(0, 1))(
        nhwc(ref), nhwc(x))
    for got, want in ((a.grad, ga), (b.grad, gb)):
        want = np.asarray(want)
        err = np.abs(nhwc(got.numpy()) - want).max() / np.abs(want).max()
        assert err < SSIM_GRAD_REL, err


@pytest.mark.parametrize("weight", [0.3, -1.0])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_ssim_aux_value_grad_matches_jax(shape, weight):
    """The wrapper on the CPU against the JAX Pallas kernel in interpret
    mode and against jax.value_and_grad of weight * SSIM."""
    ref, x = bn_like_pair(shape, seed=2)
    value, d_x = ssim_aux_value_grad(torch.from_numpy(ref),
                                     torch.from_numpy(x), weight)
    assert value.dtype == torch.float32 and d_x.shape == shape
    k_value, k_grad = jax_ssim_aux_value_grad(
        jnp.asarray(ref), jnp.asarray(x), weight, interpret=True)
    v_value, v_grad = jax.value_and_grad(
        lambda xx: weight * jax_ssim(nhwc(ref), jnp.transpose(
            xx, (0, 2, 3, 1))))(jnp.asarray(x))
    for want_v, want_g in ((k_value, k_grad), (v_value, v_grad)):
        assert abs(float(value) - float(want_v)) < VALUE_TOL
        np.testing.assert_allclose(d_x.numpy(), np.asarray(want_g), rtol=0,
                                   atol=grad_tol(shape))


def test_ssim_aux_reference_float64_witness():
    """The float64 plain version from the same float32 inputs agrees with
    the float32 one to float32 rounding."""
    ref, x = (torch.from_numpy(a) for a in bn_like_pair((2, 3, 32, 32)))
    v32, g32 = ssim_aux_reference(ref, x, 0.3)
    v64, g64 = ssim_aux_reference(ref, x, 0.3, torch.float64)
    assert v64.dtype == g64.dtype == torch.float64
    assert abs(float(v32) - float(v64)) < VALUE_TOL
    assert float((g32.double() - g64).abs().max()) < grad_tol(g32.shape)


def test_ssim_aux_function_matches_autograd():
    """``SSIMAux`` (value from the wrapper, gradient scaled in its
    backward) against autograd of the aux loss; no gradient reaches the
    reference."""
    ref, x = bn_like_pair((2, 3, 16, 24), seed=3)
    r = torch.from_numpy(ref).requires_grad_(True)
    a = torch.from_numpy(x).requires_grad_(True)
    value = SSIMAux.apply(r, a, -1.0)
    (3.0 * value).backward()
    b = torch.from_numpy(x).requires_grad_(True)
    want = losses.aux_loss("ssim", -1.0)(torch.from_numpy(ref), b)
    (3.0 * want).backward()
    assert abs(float(value.detach()) - float(want.detach())) < VALUE_TOL
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                               atol=3 * grad_tol(x.shape))
    assert r.grad is None


def test_ssim_aux_checks_its_device():
    ref, x = (torch.from_numpy(a) for a in bn_like_pair((1, 3, 8, 8)))
    with pytest.raises(ValueError):
        ssim_aux_value_grad(ref.to("meta"), x.to("meta"), 1.0)


@pytest.mark.parametrize("groups", [1, 3])
def test_conv2d_f32_function_matches_conv2d(groups, rng):
    """The autograd function that runs a convolution's forward and
    backward under full float32 on the card computes F.conv2d and its
    gradients (here on the CPU, where it runs the same calls)."""
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 9, 11)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (3, 3 // groups, 3, 5))
                         .astype(np.float32))
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    xb, wb = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    out = _Conv2dF32.apply(xa, wa, groups)
    want = torch.nn.functional.conv2d(xb, wb, groups=groups)
    g = torch.from_numpy(rng.normal(0, 1, want.shape).astype(np.float32))
    out.backward(g)
    want.backward(g)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(wa.grad.numpy(), wb.grad.numpy(), rtol=0,
                               atol=1e-5)
