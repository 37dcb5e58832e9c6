"""The drift-synthesis grid with its pipelines split over devices (port
of ``raw2logit_tpu/parallel/pipelines.py``).

The JAX package shards the pipeline axis over the mesh with a switch per
device. Here each device gets a contiguous slice of the pipeline list
and runs only its own pipelines on its copy of the raw batch; the result
is the (P, B, 3, H, W) stack in planar layout. A pipeline count that is
not a multiple of the device count leaves the last devices fewer.
"""

import torch


def process_pipeline_grid(pipelines, devices, raw):
    """Every pipeline's RGB of ``raw`` (B, H, W): a (len(pipelines), B, 3,
    H, W) tensor on ``devices[0]``, pipeline i computed on device
    ``i // ceil(P / len(devices))``."""
    if not pipelines:
        raise ValueError("no pipelines")
    devices = [torch.device(d) for d in devices]
    per = -(-len(pipelines) // len(devices))
    outs = []
    for k, dev in enumerate(devices):
        mine = pipelines[k * per:(k + 1) * per]
        if mine:
            r = raw.to(dev)
            outs.extend(p(r) for p in mine)
    return torch.stack([o.to(devices[0]) for o in outs])
