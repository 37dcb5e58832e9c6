"""Hendrycks & Dietterich common-corruptions battery (port of
``raw2logit_tpu/evaluation/corruptions.py``): the 11 transforms of the C
tables and 9 extras, on NCHW (B, 3, H, W) tensors in [0, 1] on the
caller's device, at a severity in 1..5.

Each transform is a ``Corruption``: ``draw(x, severity, generator, rng)``
makes its random draws (on x's device from the ``torch.Generator``; the
plasma fractal and the motion-blur and snow angles on the host from the
``np.random.Generator``) and ``apply(x, severity, **draws)`` is the
deterministic body. The draws cannot equal the JAX package's threefry
stream, so parity with it is held on the bodies, with JAX's draws
injected. Coordinates, index maps and the noise fields that are
thresholded are float32, as in JAX; the values taken from ``x`` keep its
dtype, so that a float64 run on the CPU samples the same coordinates.
No body reads a device value on the host: a batch runs without waiting
for the card (``jpeg_compression``, which round-trips through PIL, is
the exception and no table runs it).
"""

import functools
from typing import Callable, Dict, NamedTuple

import numpy as np
import torch

from raw2logit_tpu_torch.ops.constants import on_device
from raw2logit_tpu_torch.ops.filters import conv2d_single, gaussian_filter_2d
from raw2logit_tpu_torch.ops.resample import (cached_on, map_coordinates,
                                              resize)

IMSIZE = 32


class Corruption(NamedTuple):
    """A registered transform: ``draw(x, severity, generator, rng)`` -> a
    dict of draws, ``apply(x, severity, **draws)`` -> the corrupted batch;
    calling it does both."""
    draw: Callable
    apply: Callable

    def __call__(self, x, severity=1, generator=None, rng=None):
        rng = np.random.default_rng() if rng is None else rng
        return self.apply(x, severity,
                          **self.draw(x, severity, generator, rng))


def _no_draws(x, severity, generator, rng):
    return {}


def _normal(shape, x, generator):
    return torch.randn(shape, generator=generator, device=x.device)


def _uniform(shape, x, generator, low, high):
    return torch.empty(shape, device=x.device).uniform_(low, high,
                                                        generator=generator)


def _grid(h, w):
    """Row and column coordinates of an (h, w) plane, float32, stacked:
    (2, h, w)."""
    return torch.stack(torch.meshgrid(torch.arange(h, dtype=torch.float32),
                                      torch.arange(w, dtype=torch.float32),
                                      indexing="ij"))


def _clip(x):
    return torch.clamp(x, 0, 1)


# --- the 11 transforms of the C tables -------------------------------------

def _identity(x, severity=1):
    return x


def _draw_noise(x, severity, generator, rng):
    return {"noise": _normal(x.shape, x, generator)}


def _gaussian_noise(x, severity=1, noise=None):
    c = [0.04, 0.06, 0.08, 0.09, 0.10][severity - 1]
    return _clip(x + noise.to(x.dtype) * c)


SHOT_RATES = [500, 250, 100, 75, 50]


def _draw_shot(x, severity, generator, rng):
    c = SHOT_RATES[severity - 1]
    return {"counts": torch.poisson(x.float() * c, generator=generator)}


def _shot_noise(x, severity=1, counts=None):
    """Poisson counts of rate x * c (drawn by ``_draw_shot``) over c."""
    c = SHOT_RATES[severity - 1]
    return _clip(counts.to(x.dtype) / c)


def _impulse_noise(x, severity=1, u=None):
    """Salt and pepper, amount c, half each (skimage random_noise 's&p'):
    ``u`` uniform in [0, 1), compared in float32 whatever x's dtype."""
    c = [0.01, 0.02, 0.03, 0.05, 0.07][severity - 1]
    x = torch.where(u < c / 2, 1.0, x)
    x = torch.where(u > 1 - c / 2, 0.0, x)
    return _clip(x)


def _draw_impulse(x, severity, generator, rng):
    return {"u": _uniform(x.shape, x, generator, 0.0, 1.0)}


def _speckle_noise(x, severity=1, noise=None):
    c = [0.06, 0.1, 0.12, 0.16, 0.2][severity - 1]
    return _clip(x + x * noise.to(x.dtype) * c)


def _gaussian_blur(x, severity=1):
    """skimage gaussian, per channel, mode 'nearest' (edge padding)."""
    c = [0.4, 0.6, 0.7, 0.8, 1.0][severity - 1]
    return _clip(gaussian_filter_2d(x, c, "edge"))


def _zoom_coords(h, zoom_factor):
    """The coordinates into the centre crop that ``_clipped_zoom`` samples,
    float32 as JAX's: ``arange(zh) * (ch - 1) / (zh - 1)``, trimmed to
    the h kept."""
    ch = int(np.ceil(h / zoom_factor))
    zh = int(round(ch * zoom_factor))
    scale = (ch - 1) / (zh - 1) if zh > 1 else 0.0
    coords = torch.arange(zh, dtype=torch.float32) * scale
    trim = (zh - h) // 2
    return coords[trim:trim + h]


def _clipped_zoom(img, zoom_factor):
    """Centre crop, then zoom back to size with order-1 interpolation at
    scipy.ndimage.zoom's endpoint-aligned coordinates, 'constant' mode, on
    (..., H, W) planes (the crop and its coordinates are taken from H, for
    both axes, as in JAX)."""
    h = img.shape[-2]
    ch = int(np.ceil(h / zoom_factor))
    top = (h - ch) // 2
    coords = cached_on(img.device, _zoom_coords, h, float(zoom_factor))
    n = coords.shape[0]
    crop = img[..., top:top + ch, top:top + ch]
    return map_coordinates(crop, (coords[:, None].expand(n, n),
                                  coords[None, :].expand(n, n)), "constant")


ZOOM_FACTORS = [np.arange(1, 1.06, 0.01), np.arange(1, 1.11, 0.01),
                np.arange(1, 1.16, 0.01), np.arange(1, 1.21, 0.01),
                np.arange(1, 1.26, 0.01)]


def _zoom_blur(x, severity=1):
    """The mean of x and its zooms by 6 to 26 factors: each zoom runs on
    the whole batch at once."""
    factors = ZOOM_FACTORS[severity - 1]
    out = torch.zeros_like(x)
    for z in factors:
        out = out + _clipped_zoom(x, float(z))
    return _clip((x + out) / (len(factors) + 1))


def _contrast(x, severity=1):
    c = [0.75, 0.5, 0.4, 0.3, 0.15][severity - 1]
    means = x.mean(dim=(-2, -1), keepdim=True)
    return _clip((x - means) * c + means)


def rgb_to_hsv(rgb):
    """skimage.color.rgb2hsv on (..., 3, H, W)."""
    r, g, b = rgb.unbind(-3)
    maxc = rgb.amax(dim=-3)
    minc = rgb.amin(dim=-3)
    v = maxc
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, 1.0), 0.0)
    safe = torch.where(delta > 0, delta, 1.0)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta > 0, (h / 6.0).remainder(1.0), 0.0)
    return torch.stack([h, s, v], dim=-3)


def hsv_to_rgb(hsv):
    """skimage.color.hsv2rgb on (..., 3, H, W)."""
    h, s, v = hsv.unbind(-3)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32).remainder(6)

    def select(*choices):  # choices[k] where i == k
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=-3)


def _brightness(x, severity=1):
    c = [0.05, 0.1, 0.15, 0.2, 0.3][severity - 1]
    h, s, v = rgb_to_hsv(x).unbind(-3)
    return _clip(hsv_to_rgb(torch.stack([h, s, _clip(v + c)], dim=-3)))


def _saturate(x, severity=1):
    c = [(0.3, 0.0), (0.1, 0.0), (1.5, 0.0), (2.0, 0.1),
         (2.5, 0.2)][severity - 1]
    h, s, v = rgb_to_hsv(x).unbind(-3)
    return _clip(hsv_to_rgb(torch.stack([h, _clip(s * c[0] + c[1]), v],
                                        dim=-3)))


def elastic_severity(severity, imsize=IMSIZE):
    """(displacement scale, smoothing sigma, affine jitter): the reference
    keeps its IMSIZE=32 constants at any resolution."""
    return [(imsize * 0.0, imsize * 0.0, imsize * 0.08),
            (imsize * 0.05, imsize * 0.2, imsize * 0.07),
            (imsize * 0.08, imsize * 0.06, imsize * 0.06),
            (imsize * 0.1, imsize * 0.04, imsize * 0.05),
            (imsize * 0.1, imsize * 0.03, imsize * 0.03)][severity - 1]


def elastic_control_points(h, w):
    """The affine control triangle, float32 (x, y) points."""
    center = np.float32([h // 2, w // 2])
    square = min(h, w) // 3
    return np.float32([center + square,
                       [center[0] + square, center[1] - square],
                       center - square])


def _control_points(h, w):
    return torch.from_numpy(elastic_control_points(h, w))


def _control_inverse(h, w):
    """P^-1 for P = [[x_i, y_i, 1]] over the control points, solved in
    float64 and rounded to float32: the affine through the control points
    and their jittered images is P^-1 @ pts2 (the 6x6 system of
    cv2.getAffineTransform is this 3x3 one twice)."""
    p = np.concatenate([elastic_control_points(h, w).astype(np.float64),
                        np.ones((3, 1))], axis=1)
    return torch.from_numpy(np.linalg.inv(p).astype(np.float32))


def _inverse_affine(h, w, jitter):
    """The rows of the inverse of the affine mapping the control points to
    ``jitter`` + themselves: elementwise float32 on the jitter's device
    (no solver, so nothing waits)."""
    pinv = cached_on(jitter.device, _control_inverse, h, w)
    pts1 = cached_on(jitter.device, _control_points, h, w)
    pts2 = pts1 + jitter.float()
    m = [pinv[j, 0] * pts2[0] + pinv[j, 1] * pts2[1] + pinv[j, 2] * pts2[2]
         for j in range(3)]  # m[j][k]: coefficient j of the affine's row k
    a, b, tx = m[0][0], m[1][0], m[2][0]
    c, d, ty = m[0][1], m[1][1], m[2][1]
    det = a * d - b * c
    return ((d / det, -b / det, (b * ty - d * tx) / det),
            (-c / det, a / det, (c * tx - a * ty) / det))


def _draw_elastic(x, severity, generator, rng):
    c = elastic_severity(severity)
    h, w = x.shape[-2:]
    return {"jitter": _uniform((3, 2), x, generator, -c[2], c[2]),
            "dx_noise": _uniform((h, w), x, generator, -1.0, 1.0),
            "dy_noise": _uniform((h, w), x, generator, -1.0, 1.0)}


def _elastic_transform(x, severity=1, jitter=None, dx_noise=None,
                       dy_noise=None):
    """Random affine, then a gaussian-smoothed displacement field, in two
    resampling stages: the affine pull with mode 'mirror'
    (cv2.BORDER_REFLECT_101), the displacement with mode 'reflect'; both
    order 1."""
    c = elastic_severity(severity)
    h, w = x.shape[-2:]
    rows = _inverse_affine(h, w, jitter)
    yy, xx = cached_on(x.device, _grid, h, w)
    src_x = rows[0][0] * xx + rows[0][1] * yy + rows[0][2]
    src_y = rows[1][0] * xx + rows[1][1] * yy + rows[1][2]
    dx, dy = (n.float() for n in (dx_noise, dy_noise))
    if c[1] > 0:
        dx = gaussian_filter_2d(dx, c[1], "symmetric", truncate=3.0) * c[0]
        dy = gaussian_filter_2d(dy, c[1], "symmetric", truncate=3.0) * c[0]
    else:
        dx, dy = dx * c[0], dy * c[0]
    affined = map_coordinates(x, (src_y, src_x), "mirror")
    return _clip(map_coordinates(affined, (yy + dy, xx + dx), "reflect"))


def distort(x, transform="identity", severity=1, generator=None, rng=None):
    """Apply one corruption to an NCHW batch."""
    return CORRUPTIONS[transform](x, severity, generator, rng)


# --- extras beyond the reference's 11-corruption battery -------------------

@functools.lru_cache(maxsize=None)
def _disk_kernel(radius, alias_blur=0.1):
    L = np.arange(-max(8, radius), max(8, radius) + 1)
    xx, yy = np.meshgrid(L, L)
    disk = ((xx ** 2 + yy ** 2) <= radius ** 2).astype(np.float32)
    disk /= disk.sum()
    return gaussian_filter_2d(torch.from_numpy(disk),
                              max(alias_blur, 1e-3), "symmetric",
                              truncate=1.0).numpy()


def _defocus_blur(x, severity=1):
    """Disk-kernel blur."""
    radius, alias = [(0.3, 0.4), (0.4, 0.5), (0.5, 0.6), (1, 0.2),
                     (1.5, 0.1)][severity - 1]
    return _clip(conv2d_single(x, _disk_kernel(radius, alias),
                               pad_mode="symmetric"))


def _pixelate(x, severity=1):
    """Linear (antialiased) downsample by c, then nearest upsample."""
    c = [0.95, 0.9, 0.85, 0.75, 0.65][severity - 1]
    h, w = x.shape[-2:]
    small = resize(x, (max(1, int(h * c)), max(1, int(w * c))), "linear")
    return _clip(resize(small, (h, w), "nearest"))


def _jpeg_compression(x, severity=1):
    """A JPEG round trip through PIL, on the host."""
    from io import BytesIO
    from PIL import Image
    q = [80, 65, 58, 50, 40][severity - 1]
    out = []
    for img in _clip(x).permute(0, 2, 3, 1).cpu().numpy():
        buf = BytesIO()
        Image.fromarray((img * 255).astype(np.uint8)).save(buf, "JPEG",
                                                           quality=q)
        out.append(np.asarray(Image.open(buf), np.float32) / 255.0)
    return torch.from_numpy(np.stack(out)).permute(0, 3, 1, 2).to(
        device=x.device, dtype=x.dtype)


def _plasma_fractal(rng, mapsize, wibbledecay):
    """Diamond-square fractal heightmap in [0, 1], float64, drawn from the
    np.random.Generator ``rng``."""
    maparray = np.zeros((mapsize, mapsize), np.float64)
    stepsize = mapsize
    wibble = 100.0

    def wibbledmean(array):
        # amplitude wibble^2, as the reference's wibble * uniform(-wibble,
        # wibble)
        return array / 4 + wibble * rng.uniform(-wibble, wibble,
                                                array.shape)

    while stepsize >= 2:
        corner = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        drsum = corner + np.roll(corner, -1, 0) + np.roll(corner, -1, 1) + \
            np.roll(np.roll(corner, -1, 0), -1, 1)
        maparray[stepsize // 2:mapsize:stepsize,
                 stepsize // 2:mapsize:stepsize] = wibbledmean(drsum)
        drgrid = maparray[stepsize // 2:mapsize:stepsize,
                          stepsize // 2:mapsize:stepsize]
        ulgrid = maparray[0:mapsize:stepsize, 0:mapsize:stepsize]
        ltsum = drgrid + np.roll(drgrid, 1, 0) + ulgrid + \
            np.roll(ulgrid, -1, 1)
        maparray[0:mapsize:stepsize,
                 stepsize // 2:mapsize:stepsize] = wibbledmean(ltsum)
        ttsum = drgrid + np.roll(drgrid, 1, 1) + ulgrid + \
            np.roll(ulgrid, -1, 0)
        maparray[stepsize // 2:mapsize:stepsize,
                 0:mapsize:stepsize] = wibbledmean(ttsum)
        stepsize //= 2
        wibble /= wibbledecay
    maparray -= maparray.min()
    return maparray / maparray.max()


def _mapsize(x):
    return 1 << int(np.ceil(np.log2(max(x.shape[-2:]))))


def _to_device(a, x):
    """A host array as a float32 tensor on x's device, copied without
    waiting for the card."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(x.device,
                                                          non_blocking=True)


FOG = [(0.2, 3), (0.5, 3), (0.75, 2.5), (1, 2), (1.5, 1.75)]


def _draw_fog(x, severity, generator, rng):
    h, w = x.shape[-2:]
    return {"fract": _plasma_fractal(rng, _mapsize(x),
                                     FOG[severity - 1][1])[:h, :w]}


def _fog(x, severity=1, fract=None):
    """A plasma-fractal fog overlay (``fract``, (H, W) in [0, 1])."""
    c = FOG[severity - 1]
    max_val = x.amax(dim=(-3, -2, -1), keepdim=True)
    out = x + c[0] * _to_device(fract, x).to(x.dtype)
    return _clip(out * max_val / (max_val + c[0]))


def _luma(x):
    """Rec.601 luma (cv2.COLOR_RGB2GRAY weights) of (B, 3, H, W)."""
    return 0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]


def _motion_blur_plane(plane, radius, sigma, angle_deg):
    """A one-sided gaussian trail along ``angle_deg`` on (..., H, W)
    planes: taps t = 0..radius weighted exp(-t^2 / 2 sigma^2),
    normalised, each an order-1 sample with mode 'mirror' at the float32
    offset (sin, cos) * t."""
    h, w = plane.shape[-2:]
    taps = np.arange(int(radius) + 1)
    weights = np.exp(-taps ** 2 / (2.0 * sigma ** 2))
    weights /= weights.sum()
    rad = angle_deg * np.pi / 180.0
    sin, cos = np.float32(np.sin(rad)), np.float32(np.cos(rad))
    yy, xx = cached_on(plane.device, _grid, h, w)
    acc = torch.zeros_like(plane)
    for t, wt in zip(taps, weights):
        t = np.float32(t)
        acc = acc + float(wt) * map_coordinates(
            plane, (yy + float(sin * t), xx + float(cos * t)), "mirror")
    return acc


MOTION = [(6, 1), (6, 1.5), (6, 2), (8, 2), (9, 2.5)]


def _draw_motion(x, severity, generator, rng):
    return {"angle": float(rng.uniform(-45, 45))}


def _motion_blur(x, severity=1, angle=0.0):
    """Directional blur at ``angle`` degrees."""
    radius, sigma = MOTION[severity - 1]
    return _clip(_motion_blur_plane(x, radius, sigma, angle))


GLASS = [(0.05, 1, 1), (0.25, 1, 1), (0.4, 1, 1), (0.25, 1, 2),
         (0.4, 1, 2)]


def _draw_glass(x, severity, generator, rng):
    _, max_delta, iters = GLASS[severity - 1]
    h, w = x.shape[-2:]
    return {"shifts": [tuple(
        torch.randint(-max_delta, max_delta + 1, (h, w),
                      generator=generator, device=x.device)
        for _ in range(2)) for _ in range(iters)]}


def _glass_blur(x, severity=1, shifts=()):
    """Gaussian blur, then each pixel gathered from its neighbour at
    (dy, dx) of each of ``shifts`` (edges clamped), then gaussian blur."""
    sigma = GLASS[severity - 1][0]
    h, w = x.shape[-2:]
    out = gaussian_filter_2d(x, sigma, "edge")
    yy, xx = (g.to(torch.int64) for g in cached_on(x.device, _grid, h, w))
    for dy, dx in shifts:
        out = out[..., (yy + dy).clamp(0, h - 1), (xx + dx).clamp(0, w - 1)]
    return _clip(gaussian_filter_2d(out, sigma, "edge"))


FROST = [(1, 0.2), (1, 0.3), (0.9, 0.4), (0.85, 0.4), (0.75, 0.45)]


def _draw_frost(x, severity, generator, rng):
    h, w = x.shape[-2:]
    return {"fract": _plasma_fractal(rng, _mapsize(x), 2.0)[:h, :w]}


def _frost(x, severity=1, fract=None):
    """A procedural frost texture (a sharpened plasma fractal ``fract``
    tinted icy blue-white) blended over x."""
    c = FROST[severity - 1]
    crystals = np.clip((fract - 0.6) / 0.4, 0, 1) ** 0.5
    tex = np.stack([0.85 * crystals, 0.92 * crystals, 1.0 * crystals])
    return _clip(c[0] * x + c[1] * _to_device(tex, x).to(x.dtype))


SNOW = [(0.1, 0.2, 1, 0.6, 8, 3, 0.95), (0.1, 0.2, 1, 0.5, 10, 4, 0.9),
        (0.15, 0.3, 1.75, 0.55, 10, 4, 0.9),
        (0.25, 0.3, 2.25, 0.6, 12, 6, 0.85),
        (0.3, 0.3, 1.25, 0.65, 14, 12, 0.8)]


def _draw_snow(x, severity, generator, rng):
    return {"layer": _normal(x.shape[-2:], x, generator),
            "angle": float(rng.uniform(-135, -45))}


def _snow(x, severity=1, layer=None, angle=0.0):
    """A snow layer (``layer``: standard-normal (H, W) noise, scaled,
    zoomed, thresholded and motion-blurred along ``angle``, all in
    float32), added with its 180-degree rotation over a contrast-lifted
    image."""
    c = SNOW[severity - 1]
    layer = c[0] + c[1] * layer.float()
    layer = _clipped_zoom(layer, c[2])
    layer = _clip(torch.where(layer < c[3], 0.0, layer))
    layer = _motion_blur_plane(layer, c[4], c[5], angle)
    gray = _luma(x)[:, None] * 1.5 + 0.5
    lifted = c[6] * x + (1 - c[6]) * torch.maximum(x, gray)
    return _clip(lifted + (layer + layer.flip(-2, -1)).to(x.dtype))


def _sobel_mag(plane):
    kx = np.float32([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])
    gx = conv2d_single(plane, kx, pad_mode="symmetric")
    gy = conv2d_single(plane, kx.T, pad_mode="symmetric")
    return torch.sqrt(gx * gx + gy * gy + 1e-12)


SPATTER = [(0.62, 0.1, 0.7, 0.7, 0.5, 0), (0.65, 0.1, 0.8, 0.7, 0.5, 0),
           (0.65, 0.3, 1, 0.69, 0.5, 0), (0.65, 0.1, 0.7, 0.69, 0.6, 1),
           (0.65, 0.1, 0.5, 0.68, 0.6, 1)]
WATER = np.float32([175 / 255.0, 238 / 255.0, 238 / 255.0])
MUD = np.float32([63 / 255.0, 42 / 255.0, 20 / 255.0])


def _draw_spatter(x, severity, generator, rng):
    return {"liquid": _normal(x.shape[-2:], x, generator)}


def _spatter(x, severity=1, liquid=None):
    """Liquid spatter from ``liquid`` (standard-normal (H, W) noise): the
    water branch weights a pale-turquoise film by the droplets' edges, the
    mud branch overlays a smoothed brown mask; the liquid layer is
    float32."""
    c = SPATTER[severity - 1]
    liquid = gaussian_filter_2d(c[0] + c[1] * liquid.float(), c[2],
                                "symmetric")
    if c[5] == 0:
        liquid = torch.where(liquid < c[3], 0.0, liquid)
        m = liquid * _sobel_mag(liquid)
        m = (m / (m.max() + 1e-12) * c[4]).to(x.dtype)
        color = on_device(WATER, x.dtype, x.device).reshape(3, 1, 1)
        return _clip(x + m * color)
    m = torch.where(liquid > c[3], 1.0, 0.0)
    m = gaussian_filter_2d(m, c[4], "symmetric")
    m = torch.where(m < 0.8, 0.0, m).to(x.dtype)
    color = on_device(MUD, x.dtype, x.device).reshape(3, 1, 1)
    return _clip(x * (1 - m) + m * color)


identity = Corruption(_no_draws, _identity)
gaussian_noise = Corruption(_draw_noise, _gaussian_noise)
shot_noise = Corruption(_draw_shot, _shot_noise)
impulse_noise = Corruption(_draw_impulse, _impulse_noise)
speckle_noise = Corruption(_draw_noise, _speckle_noise)
gaussian_blur = Corruption(_no_draws, _gaussian_blur)
zoom_blur = Corruption(_no_draws, _zoom_blur)
contrast = Corruption(_no_draws, _contrast)
brightness = Corruption(_no_draws, _brightness)
saturate = Corruption(_no_draws, _saturate)
elastic_transform = Corruption(_draw_elastic, _elastic_transform)
defocus_blur = Corruption(_no_draws, _defocus_blur)
pixelate = Corruption(_no_draws, _pixelate)
jpeg_compression = Corruption(_no_draws, _jpeg_compression)
fog = Corruption(_draw_fog, _fog)
motion_blur = Corruption(_draw_motion, _motion_blur)
glass_blur = Corruption(_draw_glass, _glass_blur)
frost = Corruption(_draw_frost, _frost)
snow = Corruption(_draw_snow, _snow)
spatter = Corruption(_draw_spatter, _spatter)

CORRUPTIONS: Dict[str, Corruption] = {
    "identity": identity,
    "gaussian_noise": gaussian_noise,
    "shot_noise": shot_noise,
    "impulse_noise": impulse_noise,
    "speckle_noise": speckle_noise,
    "gaussian_blur": gaussian_blur,
    "zoom_blur": zoom_blur,
    "contrast": contrast,
    "brightness": brightness,
    "saturate": saturate,
    "elastic_transform": elastic_transform,
    "defocus_blur": defocus_blur,
    "pixelate": pixelate,
    "jpeg_compression": jpeg_compression,
    "fog": fog,
    "motion_blur": motion_blur,
    "glass_blur": glass_blur,
    "frost": frost,
    "snow": snow,
    "spatter": spatter,
}
