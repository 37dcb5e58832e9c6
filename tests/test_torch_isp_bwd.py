"""PyTorch port vs the JAX package: the fused ISP's training forward and
backward (plain versions, the unpacking of the 129 gradient scalars, and
``FusedISP`` on the CPU), and the literal-reference fixture's train-mode
gradients.

All on the CPU, where the kernel wrappers run their plain versions; the
CUDA kernels are held to those by tests/test_torch_kernels_gpu.py. The
JAX kernels run in interpret mode, as tests/test_pallas.py runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.pallas.fused_isp import (_fused_fwd_planar_train,
                                            _pack_params)
from raw2logit_tpu.pallas.fused_isp import \
    fused_isp_reference as jax_fused_reference
from raw2logit_tpu.pallas.fused_isp_bwd import fused_isp_bwd_pallas

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.kernels import (PARAM_NAMES, fused_isp,
                                         fused_isp_autograd, fused_isp_bwd,
                                         fused_isp_reference, fused_isp_train,
                                         fused_isp_train_reference,
                                         pack_params)
from raw2logit_tpu_torch.kernels.fused_isp import P_A, P_GAMMA, P_MINV
from test_torch_isp import (FIXTURE, MICROSCOPY_CAM, MILD_CAM,
                            fixture_processing, jax_variables,
                            port_processing, rel_err)

# residual planes vs the JAX training kernel (tests/test_pallas.py:32)
RES_ATOL = 2e-5
# backward vs JAX, the tiers of tests/test_pallas.py:90-95
DRAW_TOL, PARAM_TOL = 1e-3, 2e-3
# FusedISP on the CPU vs autograd of the staged plain version: the two
# differ only in A = M_RGB2YUV . CCM . diag(WB) combined in float64 and
# in the order of the f32 sums
FUNCTION_RTOL = 2e-4
# the reference fixture's f32 tier (tests/test_reference_parity.py:200-216)
FIXTURE_TOL = 2e-3


@pytest.fixture
def setup(raw_batch, rng):
    """(raw (2, 64, 64), JAX params, the port's parameter dict, planar
    cotangent) with the camera of tests/test_pallas.py and seeded
    non-symmetric parameters."""
    v = jax_variables(MILD_CAM, rng, perturb=True)
    proc = port_processing(v)
    raw = raw_batch[:2]
    out, _ = _fused_fwd_planar_train(raw, _pack_params(v["params"]),
                                     interpret=True)
    g = np.asarray(out) * 0.5 + 0.1
    return raw, v["params"], proc.kernel_params(), g


def test_train_reference_matches_jax_kernel(setup):
    raw, jparams, params, _ = setup
    want, want_res = _fused_fwd_planar_train(raw, _pack_params(jparams),
                                             interpret=True)
    launches = fused_isp_train.launches
    got, res = fused_isp_train(torch.from_numpy(raw), params)
    assert fused_isp_train.launches == launches  # plain version on the CPU
    assert res.shape == (2, 5, 64, 64)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=RES_ATOL)
    np.testing.assert_allclose(res.detach().numpy(), np.asarray(want_res),
                               rtol=0, atol=RES_ATOL)


def _port_grads(grads):
    """JAX parameter gradients -> the port's names and layouts."""
    return convert.isp_state_dict({"params": jax.device_get(grads)})


@pytest.mark.parametrize("variant", ["res", "recompute"])
def test_plain_bwd_matches_jax(setup, variant):
    """The port's plain backward, unpacking and dA chain included, vs the
    JAX backward kernel (interpret mode, same variant) and vs jax.vjp of
    the JAX plain version."""
    raw, jparams, params, g = setup
    g_nhwc = jnp.transpose(jnp.asarray(g), (0, 2, 3, 1))
    jres = res = None
    if variant == "res":
        _, jres = _fused_fwd_planar_train(raw, _pack_params(jparams),
                                          interpret=True)
        _, res = fused_isp_train(torch.from_numpy(raw), params)
    got_raw, got = fused_isp_bwd(torch.from_numpy(raw), params,
                                 torch.from_numpy(g), res)
    _, vjp = jax.vjp(jax_fused_reference, jnp.asarray(raw), jparams)
    for want_raw, want in (
            fused_isp_bwd_pallas(raw, jparams, g_nhwc, interpret=True,
                                 res=jres),
            vjp(g_nhwc)):
        np.testing.assert_allclose(got_raw.numpy(), np.asarray(want_raw),
                                   rtol=DRAW_TOL, atol=DRAW_TOL)
        want = _port_grads(want)
        for name, key in zip(PARAM_NAMES, ("black_level", "debayer.weight",
                                           "white_balance",
                                           "colour_correction",
                                           "sharpening_filter.weight",
                                           "gaussian_blur.weight",
                                           "gamma_correct")):
            assert got[name].shape == params[name].shape, name
            np.testing.assert_allclose(got[name].numpy(), want[key].numpy(),
                                       rtol=PARAM_TOL, atol=PARAM_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("raw_grad", [True, False],
                         ids=["raw_and_params", "params_only"])
def test_fused_isp_function_matches_autograd(setup, raw_grad):
    """``FusedISP`` on the CPU (the training forward and the plain
    backward, paired as on the card) gives autograd's gradients of the
    plain version, for every input that requires grad (a raw batch
    without grad, as in training, gets none)."""
    raw, _, params, g = setup
    x = torch.from_numpy(raw).requires_grad_(raw_grad)
    tensors = [params[n] for n in PARAM_NAMES]
    launches = fused_isp.launches
    out = fused_isp_autograd(x, params)
    assert out.grad_fn is not None and fused_isp.launches == launches
    want = fused_isp_reference(x, params)
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=RES_ATOL)
    names = PARAM_NAMES
    if raw_grad:
        tensors, names = [x] + tensors, ("raw",) + PARAM_NAMES
    got = torch.autograd.grad(out, tensors, torch.from_numpy(g))
    ref = torch.autograd.grad(want, tensors, torch.from_numpy(g))
    for name, a, b in zip(names, got, ref):
        assert a.shape == b.shape, name
        assert rel_err(a, b) < FUNCTION_RTOL, (name, rel_err(a, b))


def test_fused_isp_autograd_serves_without_grad(setup):
    raw, _, params, _ = setup
    with torch.no_grad():
        out = fused_isp_autograd(torch.from_numpy(raw), params)
    assert out.grad_fn is None
    np.testing.assert_array_equal(
        out.numpy(), fused_isp(torch.from_numpy(raw), params).detach().numpy())


def test_fused_isp_bwd_checks_plane_shapes(setup):
    raw, _, params, g = setup
    g = torch.from_numpy(g)
    with pytest.raises(ValueError, match="res"):
        fused_isp_bwd(torch.from_numpy(raw), params, g,
                      torch.zeros(2, 4, 64, 64))
    with pytest.raises(ValueError, match="g"):
        fused_isp_bwd(torch.from_numpy(raw), params, g[:, :2].contiguous())
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_isp_bwd(torch.empty(2, 8, 8, device="meta"), params, g)


def test_train_reference_residuals_are_the_forward_planes(setup):
    """res = [deb0, deb1, deb2, s, t] reproduces the output: YUV->RGB of
    (t, U, V) with U, V = rows 1, 2 of A . deb, then clip and gamma."""
    raw, _, params, _ = setup
    packed = pack_params(params)
    out, res = fused_isp_train_reference(torch.from_numpy(raw), params)
    yuv = torch.einsum("kc,bchw->bkhw", packed[P_A:P_MINV].reshape(3, 3),
                       res[:, :3])
    t_uv = torch.cat([res[:, 4:5], yuv[:, 1:]], dim=1)
    rgb = torch.einsum("kc,bchw->bkhw",
                       packed[P_MINV:P_MINV + 9].reshape(3, 3), t_uv)
    want = torch.exp(torch.log(rgb.clamp(1e-5, 1.0)) / packed[P_GAMMA])
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-6)


# --- reference fixture: train-mode gradients, plain path -----------------

@pytest.fixture(scope="module")
def fixture_grads():
    """The port's gradients of sum(rgb * cot) in train mode on fixture A
    (tracked stages, additive layer), and the fixture."""
    fx = np.load(FIXTURE)
    proc = fixture_processing(fx, "A", MICROSCOPY_CAM, track_stages=True,
                              additive_layer=True, image_size=128).train()
    raw = torch.from_numpy(fx["A.raw"]).requires_grad_(True)
    rgb, _ = proc(raw)
    (rgb * torch.from_numpy(fx["A.cot"])).sum().backward()
    grads = {n: p.grad for n, p in proc.named_parameters()}
    grads["input"] = raw.grad
    return grads, fx


@pytest.mark.parametrize("name", [
    "black_level", "white_balance", "colour_correction", "gamma_correct",
    "sharpening_filter.weight", "gaussian_blur.weight", "debayer.weight",
    "additive_layer", "input"])
def test_fixture_train_gradients(fixture_grads, name):
    grads, fx = fixture_grads
    key = "A.input_grad_train" if name == "input" else f"A.grad_train.{name}"
    assert grads[name].shape == fx[key].shape
    assert rel_err(grads[name], fx[key]) < FIXTURE_TOL, rel_err(grads[name],
                                                                fx[key])
