"""The evaluation harness on the card: the 19 transforms of the corruption
battery that need no PIL in float32 on the card against the port's own
float64 run on the CPU, on the same draws, and the identity cell
program's logits against the CPU's float64 run, with the gates of
``chip_smoke.py``'s eval phase (``EVAL_*``); every cell program of the C
table runs without a host synchronisation; a table on the card by
default. Imports no JAX, so that it runs where the port runs:

    python -m pytest tests/test_torch_eval_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (EVAL_LOGIT_TOL, EVAL_PIPELINE, EVAL_TRANSFORMS,
                        eval_cell_gates, eval_classifier, eval_gates,
                        static_pipeline)
from raw2logit_tpu_torch.data import SyntheticRawClassification
from raw2logit_tpu_torch.evaluation.abtesting import ABTesting, pipeline_name
from raw2logit_tpu_torch.ops.filters import full_float32
from raw2logit_tpu_torch.training.checkpoint import save_module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the evaluation's card path)")
    return torch.device("cuda")


def mosaics(device, b, size, seed=0):
    ds = SyntheticRawClassification(n=b, h=size, w=size, seed=seed)
    return torch.as_tensor(np.stack([ds[i][0] for i in range(b)]),
                           device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 64), (3, 96)])
def test_battery_on_the_card_against_float64(cuda, shape):
    """Square images (zoom_blur's crop takes H for both axes, as JAX's):
    the gates raise on a failure."""
    with torch.no_grad():
        rgb = static_pipeline(*EVAL_PIPELINE)(mosaics(cuda, *shape))
    reports = eval_gates(cuda, rgb)
    assert [r["transform"] for r in reports] == list(EVAL_TRANSFORMS)
    assert len(EVAL_TRANSFORMS) == 19


@pytest.mark.gpu
def test_cell_programs_on_the_card(cuda):
    """In full float32, as chip_smoke.py runs (cuDNN's default TF32 moves
    the classifier's logits by ~5e-4)."""
    with full_float32():
        report = eval_cell_gates(cuda, mosaics(cuda, 4, 64), n_logits=4)
    assert report["identity_logits_vs_float64_max_abs"] <= EVAL_LOGIT_TOL
    assert len(report["programs_without_sync"]) == 12


@pytest.mark.gpu
def test_a_table_runs_on_the_card_by_default(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the evaluation's card path)")
    ab = ABTesting("SyntheticMicroscopy", batch_size=4, n=6, h=64, w=64)
    assert ab.device.type == "cuda"
    name = pipeline_name(*EVAL_PIPELINE)
    path = save_module(eval_classifier(ab.device), str(tmp_path / "c.pt"))
    table = ab.c_make_table({name: [path]}, [0, 2, 5],
                            str(tmp_path / "c.json"), severities=(2,))
    cells = [v for k, v in table.items() if k != "_meta"]
    assert len(cells) == 11
    assert all(np.isfinite(x) for cell in cells for x in cell.values())
