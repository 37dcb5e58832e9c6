"""The port's static ISP on the card: every demosaic stage, Menon's
decision map and the static pipelines in float32 on the card against the
port's own float64 run on the CPU, with the gates of ``chip_smoke.py``'s
static phase (``STATIC_*``, ``MENON_*``); and the precompute's default
device. Imports no JAX, so that it runs where the port runs:

    python -m pytest tests/test_torch_static_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import STATIC_PIPELINES, static_gates, static_pipeline
from raw2logit_tpu_torch.data import (SyntheticRawClassification,
                                      precompute_pipeline_rgb)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the static ISP's card path)")
    return torch.device("cuda")


def mosaics(b, h, w, seed=0):
    """Synthetic mosaics at exposures from dark to bright."""
    ds = SyntheticRawClassification(n=b, h=h, w=w, seed=seed)
    raw = np.stack([ds[i][0] for i in range(b)])
    return torch.from_numpy(raw * np.linspace(0.05, 1.0, b)[:, None, None]
                            .astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64, 64), (3, 36, 52), (2, 18, 130)])
def test_static_isp_on_the_card_against_float64(cuda, shape):
    """Even shapes that are not squares or multiples of 32, and a strip
    whose height is close to the pads: the gates raise on a failure."""
    reports = static_gates(cuda, mosaics(*shape))
    piped = [r["pipeline"] for r in reports if r["stage"] == "pipeline"]
    assert piped == [list(p) for p in STATIC_PIPELINES]
    assert {r["debayer"] for r in reports if r["stage"] == "demosaic"} == {
        "bilinear", "malvar2004", "menon2007"}


@pytest.mark.gpu
def test_precompute_runs_on_the_card_by_default(cuda):
    """device=None is the card; the result comes back to the host as
    float32 and agrees with the CPU's run."""
    ds = SyntheticRawClassification(n=5, h=32, w=32, seed=3)
    pipe = static_pipeline("menon2007")
    got = precompute_pipeline_rgb(ds, pipe, batch_size=2)
    want = precompute_pipeline_rgb(ds, pipe, batch_size=2, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
