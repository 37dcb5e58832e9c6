"""PyTorch port vs the JAX package: the corruption battery
(``evaluation/corruptions.py``) and the resampling it rests on
(``ops/resample.py``).

All on the CPU, at 32x32 (resampling also at non-square sizes). Inputs
are made with numpy from a seed and handed to both packages; the JAX
package's images are NHWC, the port's NCHW. The deterministic transforms
are held to JAX at the bound of the JAX package's own goldens
(``tests/test_corruption_golden.py``: 2e-6). The random ones are held on
their bodies: the test recomputes JAX's draws from its key, as each JAX
transform makes them, and injects them into the port's body. JAX results
are computed once per module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.evaluation import corruptions as JC
from test_corruption_golden import golden_elastic

from raw2logit_tpu_torch.evaluation import corruptions as C
from raw2logit_tpu_torch.ops import resample

# the JAX goldens' bound (tests/test_corruption_golden.py)
ATOL = 2e-6
# elastic: the port solves the affine through the control points in
# closed form (P^-1 solved in float64 once, the inverse of the 2x3 affine
# by its adjugate), JAX by float32 LU; the coordinates then differ by
# ~1e-5 px, which moves a pixel by that times the image's slope (up to ~1
# per pixel on uniform noise)
ELASTIC_ATOL = 1e-4
# tests/test_corruption_golden.py:61-62, elastic against cv2 + scipy
GOLDEN_MAX, GOLDEN_MEAN = 5e-3, 2e-4
DETERMINISTIC = ("identity", "gaussian_blur", "zoom_blur", "contrast",
                 "brightness", "saturate", "defocus_blur", "pixelate")
RANDOM = ("gaussian_noise", "shot_noise", "impulse_noise", "speckle_noise",
          "elastic_transform", "fog", "motion_blur", "glass_blur", "frost",
          "snow", "spatter")
SEVERITIES = (1, 3, 5)


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def img():
    """Two 32x32 NHWC images in [0, 1], with flat, black, white and gray
    patches (clips, hsv's special cases)."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 32, 32, 3))
    x[0, :6, :6] = 0.0
    x[0, 6:10, :6] = 1.0
    x[1, :6, :6] = 0.4
    x[1, 6:10, :6] = [0.7, 0.7, 0.2]
    return x.astype(np.float32)


def jax_draws(name, key, x, sev):
    """The draws JAX's ``name`` makes from ``key`` on NHWC ``x``, as the
    port's body takes them."""
    h, w = x.shape[1:3]
    mapsize = 1 << int(np.ceil(np.log2(max(h, w))))
    if name in ("gaussian_noise", "speckle_noise"):
        return {"noise": t(nchw(jax.random.normal(key, x.shape)))}
    if name == "shot_noise":
        rate = [500, 250, 100, 75, 50][sev - 1]
        return {"counts": t(nchw(jax.random.poisson(key, x * rate)
                                 .astype(np.float32)))}
    if name == "impulse_noise":
        return {"u": t(nchw(jax.random.uniform(key, x.shape)))}
    if name == "elastic_transform":
        c = JC.elastic_severity(sev)
        k_aff, k_dx, k_dy = jax.random.split(key, 3)
        return {"jitter": t(np.asarray(jax.random.uniform(
                    k_aff, (3, 2), minval=-c[2], maxval=c[2]))),
                "dx_noise": t(np.asarray(jax.random.uniform(
                    k_dx, (h, w), minval=-1, maxval=1))),
                "dy_noise": t(np.asarray(jax.random.uniform(
                    k_dy, (h, w), minval=-1, maxval=1)))}
    if name == "fog":
        decay = [3, 3, 2.5, 2, 1.75][sev - 1]
        return {"fract": JC._plasma_fractal(key, mapsize, decay)[:h, :w]}
    if name == "motion_blur":
        return {"angle": float(jax.random.uniform(key, (), minval=-45,
                                                  maxval=45))}
    if name == "glass_blur":
        iters = [1, 1, 1, 2, 2][sev - 1]
        shifts = []
        for _ in range(iters):
            key, k1, k2 = jax.random.split(key, 3)
            shifts.append(tuple(t(np.asarray(jax.random.randint(
                k, (h, w), -1, 2))).long() for k in (k1, k2)))
        return {"shifts": shifts}
    if name == "frost":
        k_tex, _ = jax.random.split(key)
        return {"fract": JC._plasma_fractal(k_tex, mapsize, 2.0)[:h, :w]}
    if name == "snow":
        k_layer, k_angle = jax.random.split(key)
        return {"layer": t(np.asarray(jax.random.normal(k_layer, (h, w)))),
                "angle": float(jax.random.uniform(k_angle, (), minval=-135,
                                                  maxval=-45))}
    assert name == "spatter"
    return {"liquid": t(np.asarray(jax.random.normal(key, (h, w))))}


@pytest.fixture(scope="module")
def jax_out(img):
    """JAX's output of a transform at a severity, NCHW, computed once."""
    @functools.cache
    def run(name, sev):
        key = jax.random.key(100 + sev)
        return nchw(JC.CORRUPTIONS[name](key, jnp.asarray(img), sev))
    return run


def test_every_jax_transform_has_a_counterpart():
    assert list(C.CORRUPTIONS) == list(JC.CORRUPTIONS)


@pytest.mark.parametrize("sev", SEVERITIES)
@pytest.mark.parametrize("name", DETERMINISTIC)
def test_deterministic_transforms_match_jax(name, sev, img, jax_out):
    got = C.CORRUPTIONS[name](t(nchw(img)), sev).numpy()
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(got, jax_out(name, sev), rtol=0, atol=ATOL)


@pytest.mark.parametrize("sev", SEVERITIES)
@pytest.mark.parametrize("name", RANDOM)
def test_random_transforms_match_jax_on_its_draws(name, sev, img, jax_out):
    """The port's body on JAX's own draws (recomputed from its key)."""
    draws = jax_draws(name, jax.random.key(100 + sev), jnp.asarray(img), sev)
    got = C.CORRUPTIONS[name].apply(t(nchw(img)), sev, **draws).numpy()
    atol = ELASTIC_ATOL if name == "elastic_transform" else ATOL
    np.testing.assert_allclose(got, jax_out(name, sev), rtol=0, atol=atol)


def test_jpeg_compression_is_jax_s_pil_round_trip(img, jax_out):
    got = C.jpeg_compression(t(nchw(img)), 3).numpy()
    np.testing.assert_array_equal(got, jax_out("jpeg_compression", 3))


def test_plasma_fractal_is_jax_s_on_its_stream():
    """JAX seeds numpy from its key's data; on that generator the port's
    fractal is JAX's, bit for bit."""
    key = jax.random.key(5)
    seed = np.asarray(jax.random.key_data(key)).ravel()[:2]
    np.testing.assert_array_equal(
        C._plasma_fractal(np.random.default_rng(seed), 32, 2.5),
        JC._plasma_fractal(key, 32, 2.5))


@pytest.mark.parametrize("sev", [1, 2, 3, 5])
def test_elastic_matches_reference_semantics(sev):
    """The port's elastic body against cv2.warpAffine + scipy
    map_coordinates (``golden_elastic``) on the same draws, at that
    golden's bounds."""
    rng = np.random.default_rng(sev)
    h = w = 64
    image = rng.uniform(0, 1, size=(h, w, 3)).astype(np.float32)
    c = JC.elastic_severity(sev)
    jitter = rng.uniform(-c[2], c[2], (3, 2)).astype(np.float32)
    dx = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    dy = rng.uniform(-1, 1, (h, w)).astype(np.float32)
    want = golden_elastic(image, jitter, dx, dy, c)
    got = C.elastic_transform.apply(t(nchw(image[None])), sev,
                                    jitter=t(jitter), dx_noise=t(dx),
                                    dy_noise=t(dy)).numpy()[0]
    err = np.abs(np.moveaxis(got, 0, -1) - want)
    assert err.max() < GOLDEN_MAX and err.mean() < GOLDEN_MEAN


def test_hsv_edge_cases_match_jax():
    """Grays (delta 0), black (max 0), primaries and a denormal-sized red:
    where a hand-written hsv can leave skimage's semantics."""
    pts = np.array([[0, 0, 0], [1, 1, 1], [.5, .5, .5], [1, 0, 0],
                    [0, 1, 0], [0, 0, 1], [1, 1, 0], [0.7, 0.7, 0.2],
                    [1e-7, 0, 0]], np.float32).reshape(1, 3, 3, 3)
    hsv = C.rgb_to_hsv(t(nchw(pts)))
    want = nchw(JC.rgb_to_hsv(jnp.asarray(pts)))
    np.testing.assert_allclose(hsv.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(
        C.hsv_to_rgb(hsv).numpy(),
        nchw(JC.hsv_to_rgb(jnp.asarray(np.moveaxis(want, -3, -1)))),
        rtol=0, atol=ATOL)


def test_draws_come_from_the_generators():
    """The same generator seeds give the same corruption, another seed
    another; every draw of a batch lands on the batch's device."""
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
    for name in RANDOM:
        runs = [C.CORRUPTIONS[name](x, 3, torch.Generator().manual_seed(s),
                                    np.random.default_rng(s))
                for s in (1, 1, 2)]
        assert torch.equal(runs[0], runs[1]), name
        assert not torch.equal(runs[0], runs[2]), name
        assert runs[0].shape == x.shape and torch.isfinite(runs[0]).all()


def test_transforms_keep_a_float64_batch_in_float64():
    """A float64 batch (the card's float32 run is held to one) stays float64
    through every body, on float32 draws."""
    x = torch.rand(1, 3, 32, 32, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0))
    for name, fn in C.CORRUPTIONS.items():
        out = fn(x, 2, torch.Generator().manual_seed(1),
                 np.random.default_rng(1))
        assert out.dtype == torch.float64, name


# --- ops/resample.py -------------------------------------------------------

def edge_coords(n, rng):
    """Coordinates along an axis of n: random ones before, inside and past
    it, the integers 0 and n - 1, and a few ulps either side of both."""
    f = np.float32
    special = [0.0, n - 1.0, np.nextafter(f(n - 1), f(n)),
               np.nextafter(np.nextafter(f(n - 1), f(n)), f(n)),
               np.nextafter(f(0), f(-1)), np.nextafter(f(n - 1), f(0)),
               -1.0, float(n), n - 0.5, -0.5]
    return np.concatenate([rng.uniform(-3, n + 2, 60),
                           np.float32(special)]).astype(np.float32)


@pytest.mark.parametrize("mode", resample.MODES)
def test_map_coordinates_matches_jax_at_and_past_the_edges(mode):
    rng = np.random.default_rng(7)
    plane = rng.uniform(0, 1, (11, 9)).astype(np.float32)
    cy, cx = edge_coords(11, rng), edge_coords(9, rng)
    cy, cx = np.meshgrid(cy, cx, indexing="ij")
    want = jax.scipy.ndimage.map_coordinates(
        jnp.asarray(plane), [jnp.asarray(cy), jnp.asarray(cx)], order=1,
        mode=mode)
    got = resample.map_coordinates(t(plane), (t(cy), t(cx)), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    # batched planes sample each plane at the same coordinates
    stack = np.stack([plane, plane[::-1].copy()])
    got2 = resample.map_coordinates(t(stack), (t(cy), t(cx)), mode)
    np.testing.assert_array_equal(got2[0].numpy(), got.numpy())


@pytest.mark.parametrize("size", [(30, 36), (40, 50), (30, 50), (32, 21),
                                  (7, 40)])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_resize_matches_jax(method, size):
    """Down (antialiased for linear), up and mixed, on NCHW: JAX resizes
    the axes whose size changes."""
    x = np.random.default_rng(8).uniform(0, 1, (2, 3, 32, 40)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3) + size, method=method)
    got = resample.resize(t(x), size, method)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
