"""On the card (marked ``gpu``; they skip where there is none): a short
run of the serving cell through ``run.py`` is correct and its trace reads
device time; the TF32 control at the cell's own size fails its limit."""

import json
import subprocess
import sys

import pytest
import torch

from h100_bench import checks, data, spec
from h100_bench.reference import step as ref_step
from h100_bench.reference.isp import initial_params
from h100_bench.reference.models import model_spec
from h100_bench.traffic import serve as serve_kind


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_serve_cell_runs_correct_on_the_card(trace):
    _card()
    out = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "cls_serve",
         "--seed", str(2 ** 31 + 99), "--seconds", "3", "--trace",
         str(trace)], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "port_kernels_roofline.serve" in line["metrics"]
        assert 0 < line["metrics"]["port_kernels_roofline.serve"]["value"] \
            <= 100


@pytest.mark.gpu
def test_tf32_control_fails_the_serve_cell_on_the_card():
    device = _card()
    cell = spec.Cell("cls_serve")
    config, traffic = cell.config, cell.traffic
    seed = 2 ** 31 + 101
    isp0, _ = initial_params(spec.camera(config), config["image_size"],
                             False, device)
    model0 = data.weights(model_spec(config["model"]), seed, device)
    batch = torch.from_numpy(serve_kind.host_batches(
        config, traffic, seed, device)[0]).to(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = ref_step.serve_batch(config, isp0, model0, batch)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        ctl = ref_step.serve_batch(config, isp0, model0, batch, tf32=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gap = checks.serve_gap([(0, ctl)], [ref])
    assert gap > cell.limits["logit_gap"], gap
