"""The port's cached device constants (``ops.constants.on_device``,
``ops.resample.cached_on``, the fused ISP's colour matrices, the SSIM
kernel's taps) are made outside inference mode, whatever mode their first
caller runs in: a serving call (``Predictor``, under
``torch.inference_mode``) that fills a cache must leave tensors that a
later train step in the same process can save for its backward. On the
CPU, at a small size.
"""

import importlib

import pytest
import torch

from raw2logit_tpu_torch.ops import constants, resample
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_train_step)
from test_torch_staged import modules, mosaics, one_torch_thread  # noqa: F401

# the kernel modules (``kernels`` exports functions of their names)
fused_isp, ssim_aux = (importlib.import_module(f"raw2logit_tpu_torch.kernels."
                                               f"{name}")
                       for name in ("fused_isp", "ssim_aux"))
CACHES = (constants._device_constant, resample.cached_on,
          fused_isp._colour_matrices, ssim_aux._taps)


@pytest.fixture
def empty_caches():
    """Every cache emptied, so that the test's first call fills it."""
    for cache in CACHES:
        cache.cache_clear()
    yield
    for cache in CACHES:
        cache.cache_clear()


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel"])
def test_train_step_after_an_inference_mode_forward(use_kernel,
                                                    empty_caches):
    """The processor's eval forward under ``torch.inference_mode`` fills
    the caches, then a train step of the same modules runs its backward
    and moves every parameter."""
    proc, clf = modules("classification", use_kernel)
    raw, y = mosaics("classification")
    with torch.inference_mode():
        proc.eval()(raw)
    cfg = TrainConfig(lr=1e-3)
    state = create_train_state(cfg, proc, clf)
    before = [p.detach().clone() for p in proc.parameters()]
    mets = make_train_step(cfg, proc, clf)(state, raw, y)
    assert torch.isfinite(mets["loss"])
    assert all(not torch.equal(p.detach(), b)
               for p, b in zip(proc.parameters(), before))


@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_resize_backward_after_an_inference_mode_resize(method,
                                                         empty_caches):
    """``ops.resample.resize`` under ``torch.inference_mode`` fills its
    weight cache, then a differentiable resize of the same sizes has a
    gradient."""
    x = torch.rand(2, 3, 12, 10)
    with torch.inference_mode():
        resample.resize(x, (8, 15), method)
    xg = x.clone().requires_grad_(True)
    resample.resize(xg, (8, 15), method).square().sum().backward()
    assert xg.grad is not None and torch.isfinite(xg.grad).all()
    fn = (resample._linear_weights if method == "linear"
          else resample._nearest_index)
    assert not resample.cached_on(torch.device("cpu"), fn, 12,
                                  8).is_inference()
