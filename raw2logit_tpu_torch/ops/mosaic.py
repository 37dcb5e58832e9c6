"""Bayer mosaic packing and black-level ops (port of
``raw2logit_tpu/ops/mosaic.py``).

RGGB pattern: R at (even, even), G1 at (even, odd), G2 at (odd, even),
B at (odd, odd). Raw input is (B, H, W); outputs are NCHW.
"""

import torch

from raw2logit_tpu_torch.ops import constants


def subtract_black_level_cfa(raw, black_level):
    """Subtract the per-site black level from a CFA mosaic, keeping the
    (..., H, W) shape."""
    bl = constants.on_device(black_level, raw.dtype, raw.device)
    h, w = raw.shape[-2:]
    bl_tile = bl.reshape(2, 2)
    bl_full = bl_tile.repeat(h // 2 + h % 2, w // 2 + w % 2)[:h, :w]
    return raw - bl_full


def pack_raw(raw, black_level=None, reduce_size=True, out_channels=3):
    """raw (B, H, W) -> NCHW colour planes.

    reduce_size=True:  (B, C, H//2, W//2) half-resolution planes; for
        out_channels=3 the two greens are averaged.
    reduce_size=False: (B, C, H, W) sparse mosaic scatter with zeros at
        the missing sites (the input of the convolutional debayer).
    """
    if out_channels not in (3, 4):
        raise ValueError(f"out_channels must be 3 or 4, got {out_channels}")
    if black_level is None:
        black_level = torch.zeros(4, dtype=raw.dtype, device=raw.device)
    bl = torch.as_tensor(black_level, dtype=raw.dtype, device=raw.device)

    r = raw[:, 0::2, 0::2] - bl[0]
    g1 = raw[:, 0::2, 1::2] - bl[1]
    g2 = raw[:, 1::2, 0::2] - bl[2]
    b = raw[:, 1::2, 1::2] - bl[3]

    if reduce_size:
        if out_channels == 3:
            return torch.stack([r, (g1 + g2) / 2.0, b], dim=1)
        return torch.stack([r, g1, g2, b], dim=1)

    bsz, h, w = raw.shape
    out = raw.new_zeros((bsz, out_channels, h, w))
    g2_channel = 1 if out_channels == 3 else 2
    out[:, 0, 0::2, 0::2] = r
    out[:, 1, 0::2, 1::2] = g1
    out[:, g2_channel, 1::2, 0::2] = g2
    out[:, out_channels - 1, 1::2, 1::2] = b
    return out


def bayer_masks(h, w, dtype=torch.float32, device=None):
    """(R, G, B) binary site masks for an RGGB CFA of shape (h, w)."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    even_r, even_c = rows % 2 == 0, cols % 2 == 0
    r_m = (even_r & even_c).to(dtype)
    b_m = (~even_r & ~even_c).to(dtype)
    g_m = ((even_r & ~even_c) | (~even_r & even_c)).to(dtype)
    return r_m, g_m, b_m
