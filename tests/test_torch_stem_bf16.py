"""PyTorch port vs the JAX package: the fused stem in bfloat16.

The port's plain bfloat16 stem (``stem_train`` forward and its backward,
``stem_eval``; on the CPU every wrapper runs its plain version) against
JAX's ``stem_train(x, w, gamma, beta, 1e-5, jnp.bfloat16, interpret=True)``
with its ``jax.vjp`` and ``stem_eval(..., jnp.bfloat16, True)`` at B = 2,
32x32 (the 64x32 shape and the ResNet with the stem kernel are in
``test_torch_stem_bf16_resnet.py``, to keep each file short), and the port
held to JAX's own bfloat16-against-float32 contract
(``tests/test_stem_pallas.py:84-91``).

XLA:CPU cannot execute a bfloat16 x bfloat16 -> float32 dot of the
backward kernels ("Unsupported element type for DotThunk::Execute"), so
JAX's kernels run here with each such dot evaluated on its operands
widened to float32 at HIGHEST precision (``widened_bf16_dots``): the same
products, which are exact in float32, summed in float32, as the MXU does.
Nothing in the JAX package changes.

Bounds (measured on the CPU, written beside each): the batch statistics
4e-7 relative (bound 1e-5); pooled bitwise equal on 100% of elements at
32x32 (bound: 99%, the rest within one bfloat16 ulp); gradients within
8e-6 of each gradient's largest magnitude (d_x 7.9e-6, dW 7.6e-6, dgamma
1.9e-7, dbeta 0; bound 5e-5): a d_a that rounds to the other side of a
bfloat16 tie between the frameworks' float32 orders of summation moves a
few products by one ulp.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import lax as jax_lax_impl

from raw2logit_tpu.pallas import stem as jstem

from raw2logit_tpu_torch.kernels import stem

STATS_REL = 1e-5
BITWISE_SHARE = 0.99
GRAD_SCALE_TOL = 5e-5
# tests/test_stem_pallas.py:84-91: bfloat16 against the float32 reference
CONTRACT_MEDIAN, CONTRACT_MAX = 0.01, 0.08


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for torch: the suite runs several test
    processes at once on a few cores, and a thread pool per process the
    size of the machine oversubscribes them; a multi-threaded CPU
    convolution may also sum in another order from run to run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def widened_bf16_dots():
    """Within: every lax.dot_general of two bfloat16 operands into float32
    computes on the operands widened to float32, at HIGHEST precision."""
    orig = jax_lax_impl.dot_general

    def dot_general(lhs, rhs, dimension_numbers, precision=None,
                    preferred_element_type=None, **kwargs):
        if (getattr(lhs, "dtype", None) == jnp.bfloat16
                and getattr(rhs, "dtype", None) == jnp.bfloat16
                and preferred_element_type == jnp.float32):
            return orig(lhs.astype(jnp.float32), rhs.astype(jnp.float32),
                        dimension_numbers,
                        precision=jax.lax.Precision.HIGHEST,
                        preferred_element_type=jnp.float32, **kwargs)
        return orig(lhs, rhs, dimension_numbers, precision=precision,
                    preferred_element_type=preferred_element_type, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lax_impl, "dot_general", dot_general)
        mp.setattr(jax.lax, "dot_general", dot_general)
        yield


def stem_inputs(shape, seed=0):
    """x NHWC, w HWIO, gamma, beta, running mean and variance (numpy), as
    tests/test_stem_pallas.py:17-25 (and ``test_torch_stem.py``)."""
    b, h, w = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, w, 3)).astype(np.float32),
            rng.normal(scale=0.1, size=(7, 7, 3, 64)).astype(np.float32),
            (1.0 + 0.1 * rng.normal(size=64)).astype(np.float32),
            (0.1 * rng.normal(size=64)).astype(np.float32),
            (0.05 * rng.normal(size=64)).astype(np.float32),
            (1.0 + 0.2 * rng.uniform(size=64)).astype(np.float32))


def nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


def port_inputs(inputs):
    x, w, *rest = inputs
    return (torch.tensor(nchw(x)),
            torch.tensor(np.transpose(w, (3, 2, 0, 1))),
            *(torch.tensor(v) for v in rest))


def f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def jax_stem_bf16(inputs, seed=7):
    """JAX's bfloat16 stem on ``inputs`` (NHWC): pooled, batch mean and
    variance, the VJP of pooled for a seeded bfloat16 cotangent (d_x,
    dW OIHW, dgamma, dbeta), the cotangent (NCHW), and the eval-mode
    pooled. Port layouts, float32 numpy."""
    x, w, g, b, m, v = (jnp.asarray(a) for a in inputs)

    def fwd(x, w, g, b):
        return jstem.stem_train(x, w, g, b, 1e-5, jnp.bfloat16, True)

    with widened_bf16_dots():
        (pooled, bm, bv), vjp = jax.vjp(fwd, x, w, g, b)
        ct = jnp.asarray(np.random.default_rng(seed).normal(
            size=pooled.shape), jnp.bfloat16)
        dx, dw, dg, db = vjp((ct, jnp.zeros_like(bm), jnp.zeros_like(bv)))
        ev = jstem.stem_eval(x, w, g, b, m, v, 1e-5, jnp.bfloat16, True)
    return {"pooled": nchw(f32(pooled)), "mean": f32(bm), "var": f32(bv),
            "grads": (nchw(f32(dx)), np.transpose(f32(dw), (3, 2, 0, 1)),
                      f32(dg), f32(db)),
            "ct": nchw(f32(ct)), "eval": nchw(f32(ev))}


def port_stem_bf16(inputs, ct):
    """The port's plain bfloat16 stem on the same inputs and cotangent."""
    x, w, g, b, m, v = port_inputs(inputs)
    leaves = [t.requires_grad_(True) for t in (x, w, g, b)]
    pooled, bm, bv = stem.stem_train(*leaves, 1e-5, torch.bfloat16)
    pooled.backward(torch.tensor(ct).bfloat16())
    with torch.no_grad():
        ev = stem.stem_eval(x, w, g, b, m, v, 1e-5, torch.bfloat16)
        ref, _, _ = stem.stem_reference(x, w, g, b, m, v, True)
    return {"pooled": pooled.detach(), "mean": bm.numpy(), "var": bv.numpy(),
            "grads": tuple(t.grad.numpy() for t in leaves), "eval": ev,
            "f32_reference": ref.numpy()}


@pytest.fixture(scope="module")
def square():
    inputs = stem_inputs((2, 32, 32), 0)
    jax_out = jax_stem_bf16(inputs)
    return jax_out, port_stem_bf16(inputs, jax_out["ct"])


def assert_bf16_close(got, want, share=BITWISE_SHARE):
    """``got`` (a bfloat16 tensor) bitwise ``want`` on at least ``share``
    of the elements, each other one within one bfloat16 ulp of the larger
    magnitude."""
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    equal = got == want
    assert equal.mean() >= share, equal.mean()
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all(), np.abs(got - want).max()


def assert_grads_close(got, want):
    for name, g, w in zip(("d_x", "dW", "dgamma", "dbeta"), got, want):
        scale = np.abs(w).max()
        err = np.abs(g - w).max() / scale
        assert err < GRAD_SCALE_TOL, (name, err)


def test_batch_statistics_match_jax(square):
    """The batch mean and variance come from the float32 accumulator in
    both (measured 4e-7 relative)."""
    jax_out, port = square
    for key in ("mean", "var"):
        want = jax_out[key]
        err = np.abs(port[key] - want).max() / np.abs(want).max()
        assert err < STATS_REL, (key, err)


def test_pooled_matches_jax_bitwise(square):
    """pooled is bfloat16 in both and equal bit for bit on 100% of the
    elements here (bound 99%, the rest within one ulp)."""
    jax_out, port = square
    assert_bf16_close(port["pooled"], jax_out["pooled"])


def test_gradients_match_jax_vjp(square):
    """d_x, dW, dgamma and dbeta against JAX's VJP on the same bfloat16
    cotangent, each within 5e-5 of its largest magnitude (measured
    7.9e-6)."""
    jax_out, port = square
    assert_grads_close(port["grads"], jax_out["grads"])


def test_eval_stem_matches_jax(square):
    """The eval-mode stem (running statistics folded): bitwise on 100%
    here (bound 99%, the rest within one ulp)."""
    jax_out, port = square
    assert_bf16_close(port["eval"], jax_out["eval"])


def test_meets_jax_bf16_contract_against_float32(square):
    """JAX's own contract for its bfloat16 stem, held by the port: against
    the float32 plain stem, median error < 1% and max < 8% of the spread
    (measured 0.06% and 0.8%)."""
    _, port = square
    ref = port["f32_reference"]
    err = np.abs(port["pooled"].float().numpy() - ref)
    spread = ref.max() - ref.min()
    assert np.median(err) / spread < CONTRACT_MEDIAN
    assert err.max() / spread < CONTRACT_MAX


def test_bf16_plain_versions_round_where_jax_does():
    """Each plain bfloat16 form stores its planes in bfloat16, keeps its
    sums float32-exact of the unrounded values, and returns float32 dW
    and d_x; a float64 plane, or a mix of dtypes, raises."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 16, 16, generator=g)
    w = 0.1 * torch.randn(64, 3, 7, 7, generator=g)
    act, s1, s2 = stem.stem_conv(x, w, dtype=torch.bfloat16)
    act32, r1, r2 = stem.stem_conv_reference(
        x.bfloat16().float(), w.bfloat16().float())
    assert act.dtype == torch.bfloat16
    torch.testing.assert_close(act, act32.bfloat16(), atol=0, rtol=0)
    torch.testing.assert_close(s1, r1, atol=0, rtol=0)
    torch.testing.assert_close(s2, r2, atol=0, rtol=0)
    ones, zeros = torch.ones(64), torch.zeros(64)
    pooled = stem.stem_bnpool(act, ones, zeros)
    assert pooled.dtype == torch.bfloat16
    d_n, _, _ = stem.stem_pool_bwd(act, pooled, ones, zeros, zeros, ones)
    assert d_n.dtype == torch.bfloat16
    coef = (ones, zeros, zeros, zeros, ones)
    assert stem.stem_conv_dw(x, act, d_n, coef).dtype == torch.float32
    assert stem.stem_conv_dx(act, d_n, coef, w).dtype == torch.float32
    with pytest.raises(NotImplementedError):
        stem.stem_bnpool(act.double(), ones, zeros)
    with pytest.raises(ValueError):
        stem.stem_pool_bwd(act, pooled.float(), ones, zeros, zeros, ones)
    with pytest.raises(NotImplementedError):
        stem.stem_train(x, w, ones, zeros, dtype=torch.float16)
