"""Data parallelism, the spatial and pipeline axes and the demo app on
the card: two gloo ranks on cuda:0 against the one-process train step,
with the stem flag off and on, the parameter gradients included
(``chip_smoke.DP_*``); full frames split
over [cuda:0, cuda:0] against the unsplit run; the 12-pipeline grid
against each pipeline; ``app.process`` on the card against the CPU.
Imports no JAX, so that it runs where the port runs:

    python -m pytest tests/test_torch_parallel_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from chip_smoke import (DP_LOSS_REL, DP_PARAM_REL, DP_STATS_REL, SPLIT_TOL,
                        dp_grad_gaps, dp_rank, dp_reference, dp_step,
                        drone_frames, free_port, launches, stats_rel)
from raw2logit_tpu_torch import app
from raw2logit_tpu_torch.data import DRONE_CAMERA_PARAMS
from raw2logit_tpu_torch.evaluation.abtesting import pipeline_grid
from raw2logit_tpu_torch.isp import ParametrizedProcessing, StaticPipeline
from raw2logit_tpu_torch.parallel import (process_full_frames,
                                          process_pipeline_grid)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_step_as_one(cuda):
    import torch.multiprocessing as mp
    batch, size = 16, 128
    one_grads = {"stem0": {}, "stem1": {}}
    one = {c: dp_step(cuda, c == "stem1", batch, size, g)
           for c, g in one_grads.items()}
    ref = dp_reference(cuda, batch, size)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(dp_rank, args=(free_port(), tmp, "cuda", batch,
                                          size),
                           nprocs=2, start_method="spawn")
        ranks = [json.load(open(os.path.join(tmp, f"{r}.json")))
                 for r in range(2)]
        rank_grads = [torch.load(os.path.join(tmp, f"{r}.pt"))
                      for r in range(2)]
    assert all(r["gloo_on_cuda"] for r in ranks)
    for case, want in one.items():
        got = ranks[0][case]
        assert ranks[1][case]["loss"] == got["loss"]
        assert abs(got["loss"] - want["loss"]) <= DP_LOSS_REL * abs(
            want["loss"])
        for key in ("isp_abs_sum", "clf_abs_sum"):
            assert abs(got[key] - want[key]) <= DP_PARAM_REL * want[key]
        assert stats_rel(got["stats"], want["stats"]) <= DP_STATS_REL
        # the gradient Adam stepped with, leaf by leaf
        gaps = dp_grad_gaps([g[case] for g in rank_grads], one_grads[case],
                            ref[f"nudged_{case}"], ref["float64"])
        assert gaps["ok"], (case, gaps)
        stem = int(case[-1])
        assert got["launches"] == launches(fwd_train=1, bwd_res=1,
                                           stem_fwd=stem, stem_bwd=stem)


@pytest.mark.gpu
@pytest.mark.parametrize("pipe", [
    ("malvar2004", "sharpening_filter", "median_denoising"),
    ("menon2007", "unsharp_masking", "gaussian_denoising"),
    ("bilinear", "unsharp_masking", "fft_denoising")], ids="-".join)
def test_full_frames_split_on_the_card(cuda, pipe):
    frames = drone_frames(2, (600, 800)).to(cuda)
    p = StaticPipeline(DRONE_CAMERA_PARAMS, *pipe)
    got = process_full_frames(p, [cuda, cuda], frames)
    assert float((got - p(frames)).abs().max()) <= SPLIT_TOL


@pytest.mark.gpu
def test_isp_kernel_split_on_the_card(cuda):
    from raw2logit_tpu_torch.kernels import fused_isp
    frames = drone_frames(2, (600, 800)).to(cuda)
    proc = ParametrizedProcessing(DRONE_CAMERA_PARAMS, image_size=None,
                                  use_kernel=True).eval()
    with torch.no_grad():
        before = fused_isp.launches
        got = process_full_frames(proc, [cuda, cuda], frames)
        assert fused_isp.launches - before == 2
        assert float((got - proc(frames)[0]).abs().max()) <= SPLIT_TOL


@pytest.mark.gpu
def test_pipeline_grid_on_the_card(cuda):
    frames = drone_frames(2, (240, 320)).to(cuda)
    pipes = [StaticPipeline(DRONE_CAMERA_PARAMS, *p) for p in pipeline_grid()]
    grid = process_pipeline_grid(pipes, [cuda, cuda], frames)
    for i, p in enumerate(pipes):
        assert torch.equal(grid[i], p(frames))


@pytest.mark.gpu
@pytest.mark.parametrize("camera", ["Microscope", "Drone"])
def test_app_process_on_the_card_against_the_cpu(cuda, camera):
    """float32 on the card against float32 on the CPU: the static gates'
    5e-4 after gamma (chip_smoke.py's STATIC_FINAL_TOL)."""
    raw = drone_frames(1, (256, 320))[0].numpy()
    got = app.process(raw, camera=camera)
    want = app.process(raw, camera=camera, device="cpu")
    assert got.shape == want.shape == (256, 320, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
