"""Extended denoisers of the static ISP: TV-Chambolle, TV-Bregman (split
Bregman) and a windowed bilateral filter (port of
``raw2logit_tpu/ops/denoise_extra.py``).

Each runs a fixed number of iterations, as the JAX package does in place
of skimage's data-dependent stop. Images are planar (..., C, H, W); the
multichannel semantics are skimage's (multichannel=True): TV per
channel, one bilateral range weight per neighbour from the colour
distance summed over channels.
"""

import math

import torch
import torch.nn.functional as F


def _grad2d(x):
    """Forward differences along H and W (zero at the far edge)."""
    gh = torch.zeros_like(x)
    gw = torch.zeros_like(x)
    gh[..., :-1, :] = x[..., 1:, :] - x[..., :-1, :]
    gw[..., :-1] = x[..., 1:] - x[..., :-1]
    return gh, gw


def _div2d(ph, pw):
    """Adjoint (negative divergence) of ``_grad2d``: per axis, p[0] first,
    p[i] - p[i - 1] inside and -p[-2] last."""
    dh = ph.clone()
    dh[..., 1:-1, :] -= ph[..., :-2, :]
    dh[..., -1, :] = -ph[..., -2, :]
    dw = pw.clone()
    dw[..., 1:-1] -= pw[..., :-2]
    dw[..., -1] = -pw[..., -2]
    return dh + dw


# TV-Chambolle: weight and iterations (a lower weight denoises less)
CHAMBOLLE_WEIGHT, CHAMBOLLE_ITERS = 0.01, 200


def denoise_tv_chambolle(img):
    """Chambolle 2004 dual projection on every (H, W) plane of ``img``
    (skimage's ND variant, ``CHAMBOLLE_ITERS`` iterations)."""
    tau = 0.25  # 1 / (2 * ndim), ndim = 2
    ph = torch.zeros_like(img)
    pw = torch.zeros_like(img)
    for _ in range(CHAMBOLLE_ITERS):
        gh, gw = _grad2d(img - _div2d(ph, pw))
        denom = 1.0 + (tau / CHAMBOLLE_WEIGHT) * torch.sqrt(gh ** 2 + gw ** 2)
        ph = (ph - tau * gh) / denom
        pw = (pw - tau * gw) / denom
    return img - _div2d(ph, pw)


def _shrink(x, lam):
    mag = torch.sqrt(torch.sum(x ** 2, dim=0, keepdim=True))
    return x * (torch.clamp(mag - lam, min=0.0) / torch.clamp(mag, min=1e-12))


# TV-Bregman: weight (a LOWER weight denoises MORE: it multiplies the
# data-fidelity term) and iterations
BREGMAN_WEIGHT, BREGMAN_ITERS = 100.0, 100


def denoise_tv_bregman(img):
    """Isotropic TV by split Bregman (Goldstein & Osher 2009) on one
    (C, H, W) image, per channel, ``BREGMAN_ITERS`` iterations.

    Like the JAX package's, it takes one image only: its neighbour sum pads
    a single (H, W) plane, so a batch raises (a batched static pipeline
    cannot use it)."""
    if img.dim() != 3:
        raise ValueError(
            f"denoise_tv_bregman takes one (C, H, W) image; got shape "
            f"{tuple(img.shape)} (the JAX package's pads (H, W) planes "
            f"only, and fails on a batch the same way)")
    lam = 2.0 * BREGMAN_WEIGHT  # skimage: lambda = 2 * weight
    gamma = 2.0

    def plane(u0):
        u = u0
        d = u0.new_zeros((2,) + u0.shape)
        b = torch.zeros_like(d)
        for _ in range(BREGMAN_ITERS):
            # one Jacobi sweep of (lam - gamma Laplacian) u
            #   = lam u0 - gamma div(d - b), with an edge-clamped
            # (non-periodic) neighbour sum
            rhs = lam * u0 - gamma * _div2d(d[0] - b[0], d[1] - b[1])
            up = F.pad(u[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
            lap_nb = (up[:-2, 1:-1] + up[2:, 1:-1]
                      + up[1:-1, :-2] + up[1:-1, 2:])
            u = (rhs + gamma * lap_nb) / (lam + 4.0 * gamma)
            g = torch.stack(_grad2d(u))
            d = _shrink(g + b, 1.0 / gamma)
            b = b + g - d
        return u

    return torch.stack([plane(c) for c in img.unbind(-3)], dim=-3)


# the bilateral filter's spatial sigma and window, max(5, 2 ceil(3 sigma) + 1)
BILATERAL_SIGMA_SPATIAL = 0.6
BILATERAL_WIN = max(5, 2 * math.ceil(3 * BILATERAL_SIGMA_SPATIAL) + 1)


def denoise_bilateral(img):
    """Windowed Gaussian bilateral filter (skimage denoise_bilateral:
    window ``BILATERAL_WIN``, zero padding).

    The colour sigma is the standard deviation (ddof 0) of the WHOLE
    ``img``, batch included, as in the JAX package: an image's result
    depends on the batch it is filtered in."""
    r = BILATERAL_WIN // 2
    sigma_color = torch.std(img, correction=0)
    h, w = img.shape[-2:]
    xp = F.pad(img, (r, r, r, r))
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            shifted = xp[..., r + dy:r + dy + h, r + dx:r + dx + w]
            sw = math.exp(-(dy * dy + dx * dx)
                          / (2.0 * BILATERAL_SIGMA_SPATIAL ** 2))
            cw = torch.exp(-torch.sum((shifted - img) ** 2, dim=-3,
                                      keepdim=True)
                           / (2.0 * sigma_color ** 2))
            wgt = sw * cw
            num = num + wgt * shifted
            den = den + wgt
    return num / torch.clamp(den, min=1e-12)
