"""CFA demosaicing of RGGB mosaics (port of ``raw2logit_tpu/ops/demosaic.py``).

Three algorithms of the static ISP:

  * bilinear    - textbook stencil interpolation
  * malvar2004  - Malvar, He, Cutler (ICASSP 2004) 5x5 linear kernels
  * menon2007   - Menon, Andriani, Calvagno (IEEE TIP 2007) DDFAPD:
                  directional green, a chrominance-gradient decision, and
                  a refining step

and ``debayer_mosaic_bilinear``, the bilinear debayer of a scattered
(..., 3, H, W) mosaic with torch 'reflect' padding.

CFA inputs are (..., H, W); outputs are planar (..., 3, H, W). The
reference's scipy conventions hold: mode='reflect' is ``symmetric``
padding for the 2-D convolutions of bilinear and Malvar, mode='mirror'
is torch ``reflect`` padding for Menon's 1-D filters, and every
convolution is a correlation with the kernels below (Menon's direction
window is stored pre-flipped).
"""

import numpy as np
import torch

from raw2logit_tpu_torch.ops import constants
from raw2logit_tpu_torch.ops.filters import conv2d_single
from raw2logit_tpu_torch.ops.mosaic import bayer_masks


def _masks(cfa):
    """The (R, G, B) site masks of ``cfa`` as bool (H, W) tensors."""
    return tuple(m.bool() for m in bayer_masks(*cfa.shape[-2:],
                                               device=cfa.device))


def _parity(cfa):
    """(even rows (H, 1), even columns (1, W)) as bool tensors: R lives
    on even rows and columns, B on odd ones."""
    h, w = cfa.shape[-2:]
    rows = torch.arange(h, device=cfa.device) % 2 == 0
    cols = torch.arange(w, device=cfa.device) % 2 == 0
    return rows[:, None], cols[None, :]


def debayer_mosaic_bilinear(mosaic):
    """Bilinear debayer of a scattered (..., 3, H, W) mosaic by
    per-channel 3x3 convolutions (K_RB, K_G, K_RB), reflect padding."""
    r, g, b = mosaic.unbind(-3)
    return torch.stack([conv2d_single(r, constants.K_RB, "reflect"),
                        conv2d_single(g, constants.K_G, "reflect"),
                        conv2d_single(b, constants.K_RB, "reflect")], dim=-3)


def demosaic_bilinear_cfa(cfa):
    """Bilinear demosaic of a (..., H, W) CFA, as colour_demosaicing's
    demosaicing_CFA_Bayer_bilinear: the masked colour planes convolved
    with the averaging stencils, symmetric padding."""
    r_m, g_m, b_m = bayer_masks(*cfa.shape[-2:], dtype=cfa.dtype,
                                device=cfa.device)
    return torch.stack(
        [conv2d_single(cfa * r_m, constants.K_RB, "symmetric"),
         conv2d_single(cfa * g_m, constants.K_G, "symmetric"),
         conv2d_single(cfa * b_m, constants.K_RB, "symmetric")], dim=-3)


# --- Malvar 2004 -------------------------------------------------------------
# The high-quality linear interpolation kernels of "High-Quality Linear
# Interpolation for Demosaicing of Bayer-Patterned Color Images" (Malvar,
# He, Cutler; ICASSP 2004).

_GR_GB = np.array(
    [[0, 0, -1, 0, 0],
     [0, 0, 2, 0, 0],
     [-1, 2, 4, 2, -1],
     [0, 0, 2, 0, 0],
     [0, 0, -1, 0, 0]], dtype=np.float32) / 8.0

_Rg_RB_Bg_BR = np.array(
    [[0, 0, 0.5, 0, 0],
     [0, -1, 0, -1, 0],
     [-1, 4, 5, 4, -1],
     [0, -1, 0, -1, 0],
     [0, 0, 0.5, 0, 0]], dtype=np.float32) / 8.0

_Rg_BR_Bg_RB = _Rg_RB_Bg_BR.T

_Rb_BB_Br_RR = np.array(
    [[0, 0, -1.5, 0, 0],
     [0, 2, 0, 2, 0],
     [-1.5, 0, 6, 0, -1.5],
     [0, 2, 0, 2, 0],
     [0, 0, -1.5, 0, 0]], dtype=np.float32) / 8.0


def demosaic_malvar2004(cfa):
    """Malvar-He-Cutler 2004 demosaic of a (..., H, W) RGGB CFA, symmetric
    padding."""
    pad_mode = "symmetric"
    r_m, g_m, b_m = bayer_masks(*cfa.shape[-2:], dtype=cfa.dtype,
                                device=cfa.device)
    r_rows, r_cols = _parity(cfa)
    b_rows, b_cols = ~r_rows, ~r_cols

    g = torch.where(g_m == 1, cfa, conv2d_single(cfa, _GR_GB, pad_mode))
    rb_gr = conv2d_single(cfa, _Rg_RB_Bg_BR, pad_mode)  # row neighbours
    rb_gc = conv2d_single(cfa, _Rg_BR_Bg_RB, pad_mode)  # column neighbours
    rb_diag = conv2d_single(cfa, _Rb_BB_Br_RR, pad_mode)

    r = cfa * r_m
    r = torch.where(r_rows & b_cols, rb_gr, r)   # G in an R row
    r = torch.where(b_rows & r_cols, rb_gc, r)   # G in a B row
    r = torch.where(b_m == 1, rb_diag, r)        # B site
    b = cfa * b_m
    b = torch.where(b_rows & r_cols, rb_gr, b)   # G in a B row
    b = torch.where(r_rows & b_cols, rb_gc, b)   # G in an R row
    b = torch.where(r_m == 1, rb_diag, b)        # R site
    return torch.stack([r, g, b], dim=-3)


# --- Menon 2007 (DDFAPD) -----------------------------------------------------

_H0 = np.array([0.0, 0.5, 0.0, 0.5, 0.0], dtype=np.float32)
_H1 = np.array([-0.25, 0.0, 0.5, 0.0, -0.25], dtype=np.float32)
_KB = np.array([0.5, 0.0, 0.5], dtype=np.float32)
_FIR = np.ones(3, dtype=np.float32) / 3.0

# Directional-gradient accumulation window (Menon 2007 eq. 9
# neighbourhood): scipy convolve() flips the kernel, so this is the
# pre-flipped (correlation) form of the causal window. It is asymmetric;
# the vertical sum takes its transpose.
_K_DIR = np.array(
    [[1, 0, 1, 0, 0],
     [0, 1, 0, 0, 0],
     [3, 0, 3, 0, 0],
     [0, 1, 0, 0, 0],
     [1, 0, 1, 0, 0]], dtype=np.float32)


def _cnv_h(x, k1d):
    """Horizontal 1-D filter, scipy mode='mirror' (torch 'reflect')."""
    return conv2d_single(x, k1d[None, :], pad_mode="reflect")


def _cnv_v(x, k1d):
    return conv2d_single(x, k1d[:, None], pad_mode="reflect")


def _shift_right2(x, dim):
    """x[..., i + 2] along ``dim``, reflected at the far edge (the
    reference's np.pad(..., (0, 2), mode='reflect') then [2:])."""
    n = x.shape[dim]
    i = torch.arange(2, n + 2, device=x.device)
    return x.index_select(dim, torch.where(i < n, i, 2 * (n - 1) - i))


def _directional(cfa, r_m, g_m, b_m):
    """The horizontal and vertical green estimates (eq. 4-5) and the
    classifier sums of the chrominance gradients (eq. 8-9)."""
    g0 = cfa * g_m.to(cfa.dtype)
    g_h = torch.where(g_m, g0, _cnv_h(cfa, _H0) + _cnv_h(cfa, _H1))
    g_v = torch.where(g_m, g0, _cnv_v(cfa, _H0) + _cnv_v(cfa, _H1))
    sums = []
    for g_d, dim, k in ((g_h, -1, _K_DIR), (g_v, -2, _K_DIR.T)):
        c = torch.where(r_m, cfa * r_m - g_d, torch.zeros_like(cfa))
        c = torch.where(b_m, cfa * b_m - g_d, c)
        d = (c - _shift_right2(c, dim)).abs()
        sums.append(conv2d_single(d, k, pad_mode="zero"))
    return g_h, g_v, sums[0], sums[1]


def menon_decision(cfa):
    """Menon's direction per site of a (..., H, W) CFA: (horizontal wins,
    the horizontal sum, the vertical sum). The decision is the hard switch
    ``sum_v >= sum_h``, so a rounding difference at a near-tie flips it."""
    _, _, sum_h, sum_v = _directional(cfa, *_masks(cfa))
    return sum_v >= sum_h, sum_h, sum_v


def demosaic_menon2007(cfa):
    """Menon-Andriani-Calvagno 2007 (DDFAPD) demosaic of (..., H, W) RGGB:
    directional green interpolation, the chrominance-gradient decision,
    colour-difference reconstruction of R and B, and the refining
    step."""
    r_m, g_m, b_m = _masks(cfa)
    r_rows, r_cols = _parity(cfa)
    b_rows, b_cols = ~r_rows, ~r_cols
    kb = _KB
    g_h, g_v, sum_h, sum_v = _directional(cfa, r_m, g_m, b_m)
    m = sum_v >= sum_h  # True: horizontal
    g = torch.where(m, g_h, g_v)

    # R and B at green sites by colour-difference interpolation (eq. 13).
    r0 = cfa * r_m.to(cfa.dtype)
    b0 = cfa * b_m.to(cfa.dtype)
    r = torch.where(g_m & r_rows, g + _cnv_h(r0, kb) - _cnv_h(g, kb), r0)
    r = torch.where(g_m & b_rows, g + _cnv_v(r0, kb) - _cnv_v(g, kb), r)
    b = torch.where(g_m & b_rows, g + _cnv_h(b0, kb) - _cnv_h(g, kb), b0)
    b = torch.where(g_m & r_rows, g + _cnv_v(b0, kb) - _cnv_v(g, kb), b)

    # R at B sites and B at R sites, along the decided direction (eq. 14).
    r = torch.where(b_rows & b_m,
                    torch.where(m, b + _cnv_h(r, kb) - _cnv_h(b, kb),
                                b + _cnv_v(r, kb) - _cnv_v(b, kb)), r)
    b = torch.where(r_rows & r_m,
                    torch.where(m, r + _cnv_h(b, kb) - _cnv_h(r, kb),
                                r + _cnv_v(b, kb) - _cnv_v(r, kb)), b)

    r, g, b = _menon_refine(r, g, b, r_m, g_m, b_m, r_rows, r_cols,
                            b_rows, b_cols, m)
    return torch.stack([r, g, b], dim=-3)


def _menon_refine(r, g, b, r_m, g_m, b_m, r_rows, r_cols, b_rows, b_cols,
                  m):
    """Menon 2007 sec. V: low-pass the colour differences and re-derive
    each plane from them at the sites where it was interpolated."""
    kb, fir = _KB, _FIR
    zero = torch.zeros_like(g)

    def along(x, k):
        return torch.where(m, _cnv_h(x, k), _cnv_v(x, k))

    # 1) G at R and B sites.
    b_g_m = torch.where(b_m, along(b - g, fir), zero)
    r_g_m = torch.where(r_m, along(r - g, fir), zero)
    g = torch.where(r_m, r - r_g_m, g)
    g = torch.where(b_m, b - b_g_m, g)

    # 2) R and B at green sites.
    r_g = r - g
    b_g = b - g
    r_g_m = torch.where(g_m & b_rows, _cnv_v(r_g, kb), r_g_m)
    r = torch.where(g_m & b_rows, g + r_g_m, r)
    r_g_m = torch.where(g_m & b_cols, _cnv_h(r_g, kb), r_g_m)
    r = torch.where(g_m & b_cols, g + r_g_m, r)
    b_g_m = torch.where(g_m & r_rows, _cnv_v(b_g, kb), b_g_m)
    b = torch.where(g_m & r_rows, g + b_g_m, b)
    b_g_m = torch.where(g_m & r_cols, _cnv_h(b_g, kb), b_g_m)
    b = torch.where(g_m & r_cols, g + b_g_m, b)

    # 3) R at B sites and B at R sites.
    r_g_m = torch.where(b_m, along(r - g, kb), r_g_m)
    r = torch.where(b_m, g + r_g_m, r)
    b_g_m = torch.where(r_m, along(b - g, kb), b_g_m)
    b = torch.where(r_m, g + b_g_m, b)
    return r, g, b


DEMOSAIC_FNS = {
    "bilinear": demosaic_bilinear_cfa,
    "malvar2004": demosaic_malvar2004,
    "menon2007": demosaic_menon2007,
}
