"""Full frames split by rows over devices (port of
``raw2logit_tpu/parallel/spatial.py``).

The JAX package shards a frame's rows over the mesh and lets XLA insert
the halo exchanges. Here each device gets a block of rows with a halo of
real image rows on each side, clipped at the frame's true borders (where
the pipeline's own padding then applies, as on the whole frame); the
block runs on its device, is cropped to its rows, and the blocks are
stitched in order. Every stage of the ISPs is a stencil or pointwise, so
a halo as deep as the pipeline's vertical receptive radius
(``halo_rows`` of ``StaticPipeline`` and ``ParametrizedProcessing``)
makes the result equal to the unsplit run. Block starts and the halo
stay even, which keeps the Bayer phase of every block. Use it where
frames are too large or too few to fill a batch, e.g. drone frames of
3000x4000.
"""

import copy

import torch


def _on(pipeline, device, cache):
    """``pipeline`` with its parameters on ``device`` (a module is copied
    once per device; a plain callable runs wherever its input is)."""
    if not isinstance(pipeline, torch.nn.Module):
        return pipeline
    key = str(device)
    if key not in cache:
        here = next(iter(pipeline.parameters()), None)
        cache[key] = (pipeline if here is None or here.device == device
                      else copy.deepcopy(pipeline).to(device))
    return cache[key]


def _run(pipeline, raw):
    out = pipeline(raw)
    return out[0] if isinstance(out, tuple) else out


def row_blocks(h, n):
    """[start, stop) rows of ``n`` blocks of a frame of ``h`` rows, the
    starts even."""
    starts = [min(h, 2 * ((i * h) // (2 * n))) for i in range(n)] + [h]
    return list(zip(starts[:-1], starts[1:]))


def process_full_frames(pipeline, devices, raw, halo=None):
    """``pipeline`` (raw (B, H, W) -> RGB (B, 3, H, W), or a module
    returning (RGB, stages)) over full frames, the rows split over
    ``devices`` (a device may repeat). ``halo`` defaults to the
    pipeline's ``halo_rows``; a pipeline whose output depends on the
    whole frame (``halo_rows`` None: train-mode output batch norm, the
    additive layer, an iterative denoiser) raises. Returns the stitched
    frames on ``devices[0]``."""
    if halo is None:
        halo = getattr(pipeline, "halo_rows", None)
        if halo is None:
            raise ValueError(
                f"{type(pipeline).__name__} gives no halo_rows: its output "
                f"depends on the whole frame (a train-mode output batch "
                f"norm, the additive layer or an iterative denoiser), or it "
                f"is a callable that needs halo= given")
    halo += halo % 2
    devices = [torch.device(d) for d in devices]
    h = raw.shape[-2]
    cache, blocks = {}, []
    for dev, (start, stop) in zip(devices, row_blocks(h, len(devices))):
        if start == stop:
            continue
        lo, hi = max(0, start - halo), min(h, stop + halo)
        out = _run(_on(pipeline, dev, cache),
                   raw[..., lo:hi, :].to(dev).contiguous())
        blocks.append(out[..., start - lo:stop - lo, :])
    return torch.cat([b.to(devices[0]) for b in blocks], dim=-2)
