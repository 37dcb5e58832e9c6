"""raw2logit in PyTorch: raw Bayer mosaics -> logits on an NVIDIA GPU.

The PyTorch port of ``raw2logit_tpu`` (the JAX package stays the
reference). Layout mirrors the JAX package: ``ops/``, ``isp/``,
``models/``, ``data/``, ``augment.py``, ``losses.py``, ``training/``
(the steps, checkpoints and the CLI ``training/train.py``),
``tracking/``, ``serving.py``; the hand-written CUDA kernels live in
``csrc/`` and their Python wrappers in ``kernels/``.

Modules run planar NCHW inside. Entry points (``Predictor``, the module
factories, the CLI) run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no device is given and CUDA is
missing.
"""

import torch


def resolve_device(device=None):
    """``device`` or, when None, ``cuda``; raises when CUDA is missing
    instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
