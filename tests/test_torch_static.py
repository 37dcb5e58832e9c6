"""PyTorch port vs the JAX package: the static ISP (pad modes, demosaics,
filters and denoisers, ``static_process`` and ``StaticPipeline``) and the
static-ISP precompute.

All on the CPU. Inputs are made with numpy from a seed and handed to both
packages; the JAX results are computed once per module (fixtures) at
small sizes. The JAX package's images are NHWC, the port's NCHW. Where
``tests/golden_numpy.py`` (scipy) has the function, the port is also held
to it at the JAX package's own tolerances (``tests/test_ops.py``,
``tests/test_isp.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_numpy as gold
from raw2logit_tpu.data import precompute as jprecompute
from raw2logit_tpu.isp import static as jstatic
from raw2logit_tpu.ops import color as jcolor
from raw2logit_tpu.ops import demosaic as jdemosaic
from raw2logit_tpu.ops import denoise_extra as jdenoise
from raw2logit_tpu.ops import filters as jfilters
from raw2logit_tpu.ops.mosaic import bayer_masks as jax_bayer_masks

from raw2logit_tpu_torch.data import (MICROSCOPY_CAMERA_PARAMS,
                                      PrecomputedRGBView,
                                      SyntheticRawClassification,
                                      precompute_pipeline_rgb)
from raw2logit_tpu_torch.isp import StaticPipeline, static_process
from raw2logit_tpu_torch.isp.static import camera_stage, filter_stage
from raw2logit_tpu_torch.ops import color, demosaic, denoise_extra, filters

# the drone camera of tests/test_isp.py
CAM = (
    [0.0625, 0.0626, 0.0625, 0.0626],
    [2.86653646, 1.0, 1.73079425],
    [1.50768983, -0.33571374, -0.17197604, -0.23048614, 1.70698738,
     -0.47650126, -0.03119153, -0.32803956, 1.35923111],
)
# the nine pipelines of tests/test_isp.py:22-27
COMBOS = [(d, s, n) for d in ("bilinear", "malvar2004", "menon2007")
          for s, n in (("sharpening_filter", "gaussian_denoising"),
                       ("unsharp_masking", "median_denoising"),
                       ("sharpening_filter", "fft_denoising"))]
# float32 against float32, two implementations: a demosaic, a filter or a
# pipeline before gamma
STAGE_ATOL = 1e-5
# against the float64 goldens: tests/test_ops.py:67 (demosaics)
GOLDEN_ATOL = 2e-5
# after gamma, whose slope is unbounded at 0: a float32 rounding of a
# pre-gamma value near the clip floor moves the output by up to ~5e-4
# (tests/test_isp.py:37)
FINAL_ATOL = 5e-4
# the median picks one of nine float32 values; only the YUV round trip
# rounds
MEDIAN_ATOL = 1e-6
# 200 float32 Chambolle iterations, both packages, at 2x32x48 and 16x16:
# they differed by 6.0e-8 at most (one float32 ulp near 0.5: the dual
# iteration contracts, so rounding does not grow with the count); 1e-6
# leaves 16x of that for other CPU builds of the libraries
CHAMBOLLE_ATOL = 1e-6


def nchw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def cfa():
    """Two 32x48 mosaics and one 16x16, seeded."""
    rng = np.random.default_rng(11)
    return {"batch": rng.uniform(0.05, 0.95, (2, 32, 48)).astype(np.float32),
            "small": rng.uniform(0.05, 0.95, (16, 16)).astype(np.float32)}


@pytest.fixture(scope="module")
def rgb():
    """Two 32x48 NHWC RGB images in [0, 1] and one 16x16, seeded."""
    rng = np.random.default_rng(12)
    return {"batch": rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32),
            "small": rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)}


# --- padding ----------------------------------------------------------------

NP_MODES = {"zero": "constant", "reflect": "reflect",
            "symmetric": "symmetric", "edge": "edge"}


@pytest.mark.parametrize("mode", sorted(NP_MODES))
@pytest.mark.parametrize("ph,pw", [(1, 1), (2, 0), (0, 3), (4, 2)])
def test_pad_modes_match_np_pad(mode, ph, pw):
    """Every pad mode against np.pad, on a (2, 3, 5, 6) stack."""
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 6)).astype(np.float32)
    got = filters._pad2d(t(x), ph, pw, mode).numpy()
    want = np.pad(x, [(0, 0), (0, 0), (ph, ph), (pw, pw)],
                  mode=NP_MODES[mode])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p", [(3, 5), (2, 7), (1, 2)])
def test_symmetric_pad_wider_than_the_axis(n, p):
    """np.pad 'symmetric' keeps reflecting past one period."""
    x = np.arange(2 * n, dtype=np.float32).reshape(2, n) + 1
    np.testing.assert_array_equal(
        filters._pad2d(t(x), p, p, "symmetric").numpy(),
        np.pad(x, p, mode="symmetric"))


@pytest.mark.parametrize("mode", sorted(NP_MODES))
def test_conv2d_single_matches_jax_in_every_pad_mode(mode):
    """An asymmetric 3x5 kernel, so that correlation and convolution, and
    every border, differ."""
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(2, 9, 11)).astype(np.float32)
    k = rng.normal(size=(3, 5)).astype(np.float32)
    got = filters.conv2d_single(t(x), k, pad_mode=mode).numpy()
    want = np.asarray(jfilters.conv2d_single(jnp.asarray(x), k,
                                             pad_mode=mode))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unknown_pad_mode_raises():
    with pytest.raises(ValueError, match="pad_mode"):
        filters.conv2d_single(torch.zeros(4, 4), np.ones((3, 3)), "wrap")


# --- demosaics --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_demosaics(cfa):
    return {(name, size): nchw(fn(jnp.asarray(cfa[size])))
            for name, fn in jdemosaic.DEMOSAIC_FNS.items()
            for size in ("batch", "small")}


@pytest.mark.parametrize("size", ["batch", "small"])
@pytest.mark.parametrize("name", ["bilinear", "malvar2004", "menon2007"])
def test_demosaic_matches_jax_and_golden(cfa, jax_demosaics, name, size):
    """Whole images, borders included: against JAX at 1e-5 and against
    the float64 golden at the JAX package's 2e-5."""
    x = cfa[size]
    got = demosaic.DEMOSAIC_FNS[name](t(x)).numpy()
    assert got.shape == x.shape[:-2] + (3,) + x.shape[-2:]
    np.testing.assert_allclose(got, jax_demosaics[name, size], rtol=0,
                               atol=STAGE_ATOL)
    golden = gold.DEMOSAIC[name]
    for img, out in zip(x.reshape(-1, *x.shape[-2:]),
                        got.reshape(-1, 3, *x.shape[-2:])):
        np.testing.assert_allclose(
            out, nchw(golden(img.astype(np.float64))), rtol=0,
            atol=GOLDEN_ATOL)


def jax_menon_decision(x):
    """The JAX package's Menon decision map, by its own helpers, as
    ``demosaic_menon2007`` computes it (``raw2logit_tpu/ops/demosaic.py``,
    lines 167-194)."""
    x = jnp.asarray(x)
    r_m, g_m, b_m = jax_bayer_masks(*x.shape[-2:], x.dtype)
    g0 = x * g_m
    g_h = jnp.where(g_m == 0, jdemosaic._cnv_h(x, jdemosaic._H0)
                    + jdemosaic._cnv_h(x, jdemosaic._H1), g0)
    g_v = jnp.where(g_m == 0, jdemosaic._cnv_v(x, jdemosaic._H0)
                    + jdemosaic._cnv_v(x, jdemosaic._H1), g0)
    sums = []
    for g_d, axis, k in ((g_h, -1, jdemosaic._K_DIR),
                         (g_v, -2, jdemosaic._K_DIR.T)):
        c = jnp.where(r_m == 1, x * r_m - g_d, 0.0)
        c = jnp.where(b_m == 1, x * b_m - g_d, c)
        d = jnp.abs(c - jdemosaic._shift_right2(c, axis=axis))
        sums.append(jfilters.conv2d_single(d, jnp.asarray(k),
                                           pad_mode="zero"))
    return np.asarray(sums[1] >= sums[0]), sums


@pytest.mark.parametrize("size", ["batch", "small"])
def test_menon_decision_map_equals_jax(cfa, size):
    """The hard switch sum_v >= sum_h, site for site: a flip at a near-tie
    would move a pixel far beyond any tolerance, so the map itself is
    held equal (and both directions occur)."""
    m, sum_h, sum_v = demosaic.menon_decision(t(cfa[size]))
    want, (jsum_h, jsum_v) = jax_menon_decision(cfa[size])
    np.testing.assert_allclose(sum_h.numpy(), np.asarray(jsum_h), rtol=0,
                               atol=STAGE_ATOL)
    np.testing.assert_allclose(sum_v.numpy(), np.asarray(jsum_v), rtol=0,
                               atol=STAGE_ATOL)
    np.testing.assert_array_equal(m.numpy(), want)
    assert 0.1 < want.mean() < 0.9


def test_menon_shift_reflects_at_the_far_edge():
    x = torch.arange(6.0)
    np.testing.assert_array_equal(demosaic._shift_right2(x, 0).numpy(),
                                  [2, 3, 4, 5, 4, 3])


@pytest.mark.parametrize("size", ["batch", "small"])
def test_debayer_mosaic_bilinear_matches_jax(rgb, size):
    x = rgb[size]
    got = demosaic.debayer_mosaic_bilinear(t(nchw(x))).numpy()
    want = nchw(jdemosaic.debayer_mosaic_bilinear(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=STAGE_ATOL)


# --- filters ----------------------------------------------------------------

FILTERS = {
    "sharpen_y": (gold.sharpening_filter, STAGE_ATOL),
    "gaussian_blur_y": (gold.gaussian_denoising, STAGE_ATOL),
    "unsharp_mask_y": (gold.unsharp_masking, STAGE_ATOL),
    "median_filter_y": (gold.median_denoising, MEDIAN_ATOL),
    "fft_denoise": (gold.fft_denoising, STAGE_ATOL),
}


@pytest.fixture(scope="module")
def jax_filtered(rgb):
    return {(name, size): nchw(getattr(jfilters, name)(jnp.asarray(x)))
            for name in FILTERS for size, x in rgb.items()}


@pytest.mark.parametrize("size", ["batch", "small"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_matches_jax_and_golden(rgb, jax_filtered, name, size):
    """Whole images, borders included, against JAX and the float64
    golden (the median at 1e-6)."""
    golden, atol = FILTERS[name]
    x = rgb[size]
    got = getattr(filters, name)(t(nchw(x))).numpy()
    np.testing.assert_allclose(got, jax_filtered[name, size], rtol=0,
                               atol=atol)
    for img, out in zip(x.reshape(-1, *x.shape[-3:]),
                        got.reshape(-1, *got.shape[-3:])):
        np.testing.assert_allclose(out, nchw(golden(img.astype(np.float64))),
                                   rtol=0, atol=atol)


def test_fft_denoise_transforms_colour_and_width():
    """The reference's quirk: an image constant along W and C passes
    unchanged (its spectrum lives at frequency 0 of both), one that varies
    along H only does too, and one that alternates along W is zeroed in
    the middle band."""
    h = np.random.default_rng(2).uniform(size=(1, 1, 8, 1))
    flat = np.broadcast_to(h, (1, 3, 8, 10)).astype(np.float32)
    np.testing.assert_allclose(filters.fft_denoise(t(flat)).numpy(), flat,
                               rtol=0, atol=1e-6)
    alt = np.broadcast_to((-1.0) ** np.arange(10), (1, 3, 8, 10)).astype(
        np.float32)  # frequency 5 of 10 along W: inside [3, 7)
    np.testing.assert_allclose(filters.fft_denoise(t(alt)).numpy(), 0.0,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("sigma,pad_mode,scipy_mode", [
    (0.5, "symmetric", "reflect"),  # gaussian_blur_y
    (1.0, "edge", "nearest")])      # unsharp_mask_y
def test_gaussian_filter_2d_matches_scipy_and_jax(sigma, pad_mode,
                                                  scipy_mode):
    from scipy import ndimage
    x = np.random.default_rng(3).uniform(size=(24, 20))
    got = filters.gaussian_filter_2d(t(x.astype(np.float32)), sigma,
                                     pad_mode).numpy()
    np.testing.assert_allclose(
        got, ndimage.gaussian_filter(x, sigma, mode=scipy_mode), rtol=0,
        atol=STAGE_ATOL)
    np.testing.assert_allclose(
        got, np.asarray(jfilters.gaussian_filter_2d(
            jnp.asarray(x, jnp.float32), sigma, pad_mode=pad_mode)), rtol=0,
        atol=1e-6)
    np.testing.assert_array_equal(
        filters.gaussian_kernel_1d(sigma).numpy(),
        np.asarray(jfilters.gaussian_kernel_1d(sigma)))


def test_unsharp_mask_kernel_and_padding():
    """Radius 1 gives a 9-tap kernel, and the blur pads with the edge
    (scipy mode='nearest'), which a ramp tells from symmetric padding at
    the border."""
    from scipy import ndimage
    assert filters.gaussian_kernel_1d(1.0).shape == (9,)
    ramp = torch.arange(12.0).repeat(6, 1)
    want = ndimage.gaussian_filter(ramp.double().numpy(), 1.0,
                                   mode="nearest")
    np.testing.assert_allclose(
        filters.gaussian_filter_2d(ramp, 1.0, "edge").numpy(), want,
        rtol=0, atol=1e-5)
    assert np.abs(filters.gaussian_filter_2d(ramp, 1.0, "symmetric").numpy()
                  - want).max() > 1e-2


def test_adjust_gamma_matches_jax(rgb):
    x = rgb["batch"]
    np.testing.assert_allclose(
        color.adjust_gamma(t(nchw(x)), 2.2).numpy(),
        nchw(jcolor.adjust_gamma(jnp.asarray(x), 2.2)), rtol=0, atol=1e-6)


# --- the extended denoisers -------------------------------------------------

@pytest.mark.parametrize("size", ["batch", "small"])
def test_tv_chambolle_matches_jax(rgb, size):
    x = rgb[size]
    got = denoise_extra.denoise_tv_chambolle(t(nchw(x))).numpy()
    want = nchw(jdenoise.denoise_tv_chambolle(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=CHAMBOLLE_ATOL)
    assert np.abs(got - nchw(x)).max() > 1e-3  # it did denoise


@pytest.mark.parametrize("size", ["batch", "small"])
def test_tv_bregman_matches_jax_on_one_image(rgb, size):
    x = rgb[size].reshape(-1, *rgb[size].shape[-3:])[0]
    got = denoise_extra.denoise_tv_bregman(t(nchw(x))).numpy()
    want = nchw(jdenoise.denoise_tv_bregman(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=STAGE_ATOL)
    assert np.abs(got - nchw(x)).max() > 1e-3


def test_bilateral_matches_jax_and_couples_the_batch(rgb):
    """sigma_color is the std of the whole batch (ddof 0): the first image
    filtered alone differs from the same image filtered beside a second,
    and the port follows JAX both ways."""
    x = rgb["batch"].copy()
    x[1] *= 0.3  # a second image that moves the batch's std
    both = denoise_extra.denoise_bilateral(t(nchw(x))).numpy()
    alone = denoise_extra.denoise_bilateral(t(nchw(x[:1]))).numpy()
    np.testing.assert_allclose(
        both, nchw(jdenoise.denoise_bilateral(jnp.asarray(x))), rtol=0,
        atol=STAGE_ATOL)
    np.testing.assert_allclose(
        alone, nchw(jdenoise.denoise_bilateral(jnp.asarray(x[:1]))), rtol=0,
        atol=STAGE_ATOL)
    assert np.abs(both[:1] - alone).max() > 1e-3


# --- the static pipeline ----------------------------------------------------

@pytest.fixture(scope="module")
def jax_static(cfa):
    """JAX's static_process before gamma (gamma 1) and after (2.2), for
    the nine pipelines, tv_chambolle and bilateral, on the 2x32x48
    batch."""
    raw = jnp.asarray(cfa["batch"])
    out = {}
    for d, s, n in COMBOS + [("bilinear", "sharpening_filter",
                              "tv_chambolle"),
                             ("menon2007", "unsharp_masking", "bilateral")]:
        for g in (1.0, 2.2):
            out[d, s, n, g] = nchw(jstatic.static_process(
                raw, *CAM, debayer=d, sharpening=s, denoising=n, gamma=g))
    return out


@pytest.mark.parametrize("debayer,sharpening,denoising", COMBOS + [
    ("bilinear", "sharpening_filter", "tv_chambolle"),
    ("menon2007", "unsharp_masking", "bilateral")])
def test_static_process_matches_jax(cfa, jax_static, debayer, sharpening,
                                    denoising):
    """Before gamma (the filter stage's clipped image; JAX's with gamma
    1) at 1e-5; after gamma at 5e-4."""
    raw = t(cfa["batch"])
    pre = filter_stage(camera_stage(raw, *CAM, debayer), sharpening,
                       denoising).numpy()
    final = static_process(raw, *CAM, debayer=debayer,
                           sharpening=sharpening,
                           denoising=denoising).numpy()
    for got, g, atol in ((pre, 1.0, STAGE_ATOL), (final, 2.2, FINAL_ATOL)):
        assert got.shape == (2, 3, 32, 48)
        np.testing.assert_allclose(got, jax_static[debayer, sharpening,
                                                   denoising, g],
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("debayer,sharpening,denoising", COMBOS)
def test_static_process_matches_golden(cfa, debayer, sharpening,
                                       denoising):
    """The float64 numpy golden of tests/test_isp.py, per image."""
    got = static_process(t(cfa["batch"]), *CAM, debayer=debayer,
                         sharpening=sharpening, denoising=denoising).numpy()
    for img, out in zip(cfa["batch"], got):
        want = gold.static_pipeline(img, *CAM, debayer=debayer,
                                    sharpening=sharpening,
                                    denoising=denoising)
        np.testing.assert_allclose(out, nchw(want), rtol=0, atol=FINAL_ATOL)


def test_static_process_single_image(cfa):
    """(H, W) in, (3, H, W) out, as JAX's (H, W) -> (H, W, 3)."""
    x = cfa["small"]
    got = static_process(t(x), *CAM, debayer="menon2007")
    assert got.shape == (3, 16, 16)
    want = nchw(jstatic.static_process(jnp.asarray(x), *CAM,
                                       debayer="menon2007"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FINAL_ATOL)


def test_static_pipeline_defaults_match_jax(cfa):
    """The class defaults: bilinear, unsharp masking and gaussian
    denoising (not the reference class's inert 'gaussian'), and the
    call runs static_process with them."""
    fields = {f.name: f.default
              for f in jstatic.StaticPipeline.__dataclass_fields__.values()
              if f.name != "camera_parameters"}
    pipe = StaticPipeline(camera_parameters=CAM)
    assert fields == {"debayer": "bilinear",
                      "sharpening": "unsharp_masking",
                      "denoising": "gaussian_denoising"}
    assert {k: getattr(pipe, k) for k in fields} == fields
    raw = t(cfa["batch"])
    np.testing.assert_array_equal(pipe(raw).numpy(),
                                  static_process(raw, *CAM).numpy())
    want = nchw(jstatic.StaticPipeline(camera_parameters=CAM)(
        jnp.asarray(cfa["batch"])))
    np.testing.assert_allclose(pipe(raw).numpy(), want, rtol=0,
                               atol=FINAL_ATOL)


def test_static_process_refuses_tv_bregman_as_jax_does():
    """The pipeline always runs a batch, and TV-Bregman takes one image:
    JAX raises on its pad, the port says why."""
    raw = np.random.default_rng(4).uniform(size=(2, 32, 32)).astype(
        np.float32)
    with pytest.raises(ValueError, match="pad_width"):
        jstatic.static_process(jnp.asarray(raw), *MICROSCOPY_CAMERA_PARAMS,
                               denoising="tv_bregman")
    with pytest.raises(ValueError, match="one \\(C, H, W\\) image"):
        static_process(t(raw), *MICROSCOPY_CAMERA_PARAMS,
                       denoising="tv_bregman")


# --- the precompute ---------------------------------------------------------

def test_precompute_matches_jax_and_pads_the_ragged_batch():
    """Five 32x32 images in batches of three with the batch-coupled
    bilateral denoiser: the last batch is the fourth and fifth images and
    a copy of the fourth, as in JAX, so their result is the pipeline's on
    that padded batch and not on the two alone.

    JAX's precompute jits the pipeline, and its bilateral filter cannot be
    traced (``int(jnp.ceil(...))`` of its window), so the JAX side is its
    static pipeline run eagerly on the batches its precompute forms; with
    the default denoiser the two precomputes are compared directly."""
    import jax
    ds = SyntheticRawClassification(n=5, h=32, w=32, seed=7)
    raws = np.stack([ds[i][0] for i in range(5)])
    pipe = StaticPipeline(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                          denoising="bilateral")
    got = precompute_pipeline_rgb(ds, pipe, batch_size=3, device="cpu")
    assert got.shape == (5, 3, 32, 32) and got.dtype == np.float32
    jpipe = jstatic.StaticPipeline(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                                   denoising="bilateral")
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jprecompute.precompute_pipeline_rgb(ds, jpipe, batch_size=3)
    want = np.concatenate([nchw(jpipe(jnp.asarray(raws[rows])))[:n]
                           for rows, n in (([0, 1, 2], 3), ([3, 4, 3], 2))])
    np.testing.assert_allclose(got, want, rtol=0, atol=FINAL_ATOL)

    plain = StaticPipeline(camera_parameters=MICROSCOPY_CAMERA_PARAMS)
    np.testing.assert_allclose(
        precompute_pipeline_rgb(ds, plain, batch_size=2, device="cpu"),
        nchw(jprecompute.precompute_pipeline_rgb(
            ds, jstatic.StaticPipeline(
                camera_parameters=MICROSCOPY_CAMERA_PARAMS), batch_size=2)),
        rtol=0, atol=FINAL_ATOL)

    # the full batch: the in-graph pipeline on it; the ragged one: on the
    # padded batch
    np.testing.assert_array_equal(got[:3], pipe(t(raws[:3])).numpy())
    np.testing.assert_array_equal(got[3:],
                                  pipe(t(raws[[3, 4, 3]])).numpy()[:2])
    assert np.abs(got[3:] - pipe(t(raws[3:])).numpy()).max() > 1e-3

    view = PrecomputedRGBView(ds, got)
    assert len(view) == 5 and view.task == "classification"
    x, y = view[3]
    np.testing.assert_array_equal(x, got[3])
    assert y == ds.labels[3]
    with pytest.raises(ValueError, match="rgb rows"):
        PrecomputedRGBView(ds, got[:4])


def test_precompute_indices_and_default_device():
    ds = SyntheticRawClassification(n=4, h=16, w=16, seed=8)
    pipe = StaticPipeline(camera_parameters=MICROSCOPY_CAMERA_PARAMS)
    got = precompute_pipeline_rgb(ds, pipe, batch_size=8, indices=[3, 1],
                                  device="cpu")
    want = pipe(t(np.stack([ds[3][0], ds[1][0]]))).numpy()
    np.testing.assert_array_equal(got, want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            precompute_pipeline_rgb(ds, pipe)
