"""The stem kernels' bfloat16 forms on the card: each against its plain
bfloat16 version and a float64 witness on the same bfloat16-rounded
operands (``chip_smoke.stem_bf16_agreement``, the ``BF16_*`` limits), at
the shapes of ``tests/test_torch_kernels_gpu.py`` (68x44 and B = 1100
among them) and at shapes that cut the tensor-core tiles of dW and d_x at
every edge, and at shapes that cut the conv forward's tensor-core tile
and the BN-pool's strips, two launches bitwise equal; the three
tensor-core kernels' SASS holding HMMA instructions, and the float32
forms' none; the bfloat16
ResNet with the stem flag launching the bfloat16 forms and no float32
one; and what the forms refuse. Imports no JAX, so that it runs where the
port runs:

    python -m pytest tests/test_torch_bf16_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import os
import re
import shutil
import subprocess

import pytest
import torch

from chip_smoke import (BF16_ARGMAX, BF16_DRIFT_MAX, BF16_DRIFT_MEDIAN,
                        drift, stem_bf16_agreement, stem_input, stem_params)
from raw2logit_tpu_torch.kernels import (stem_bnpool, stem_conv,
                                         stem_conv_dw, stem_conv_dx,
                                         stem_eval, stem_pool_bwd,
                                         stem_train)
from raw2logit_tpu_torch.kernels.build import library_path, load
from raw2logit_tpu_torch.models import ResNet
from test_torch_kernels_gpu import POOL_BWD_SHAPES, cuda  # noqa: F401

WRAPPERS = (stem_conv, stem_bnpool, stem_pool_bwd, stem_conv_dw,
            stem_conv_dx)


def launched(fn):
    """(float32, bfloat16) launches of each stem wrapper after ``fn()``."""
    before = [(w.launches, w.launches_bf16) for w in WRAPPERS]
    fn()
    torch.cuda.synchronize()
    return [(w.launches - a, w.launches_bf16 - b)
            for w, (a, b) in zip(WRAPPERS, before)]


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["isp", "random"])
@pytest.mark.parametrize("shape", [(4, 3, 256, 256), (3, 3, 68, 44),
                                   (1, 3, 4, 8), (2, 3, 100, 140),
                                   *POOL_BWD_SHAPES], ids=str)
def test_stem_bf16_forms_match_plain(shape, inputs, cuda):  # noqa: F811
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, shape, inputs)
    for name, (stats, ok) in stem_bf16_agreement(
            x, w, gamma, beta, inputs == "random").items():
        assert ok, (name, stats)


# The tensor-core dW and d_x both tile 16 x 32 positions; dW stages two
# rows (four k16 steps of 16 positions) at a time, d_x walks 16-channel
# chunks. Ho = 18 and Wo = 34: one stage and one column pair past a tile
# (rows of 34, no 16-byte copies); Ho = 34, Wo = 48: two tiles and a
# stage down, one k16 step past a tile across (16-byte copies); Ho = 10,
# Wo = 20: less than a tile, rows not a multiple of the k16 step; Ho = 2,
# Wo = 36: one stage, a tile and a column pair across. B = 1 throughout.
TILE_EDGE_SHAPES = [(1, 3, 36, 68), (1, 3, 68, 96), (1, 3, 20, 40),
                    (1, 3, 4, 72)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TILE_EDGE_SHAPES, ids=str)
def test_stem_bf16_forms_at_the_tensor_core_tile_edges(shape,
                                                       cuda):  # noqa: F811
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, shape, "random")
    for name, (stats, ok) in stem_bf16_agreement(x, w, gamma, beta,
                                                 True).items():
        assert ok, (name, stats)


# The tensor-core conv forward tiles 8 x 32 positions (a warp a row, four
# 8-position MMA tiles across); the BN-pool walks 128-column strips in
# units of 8 window rows, 16-byte rows where Wo is a multiple of 8. Ho =
# 10, Wo = 34: two rows and a column pair past a tile; Ho = 16, Wo = 40:
# two tiles down, an 8-position MMA tile past one across; Ho = 6, Wo = 66:
# less than a tile down, a column pair past two across, B = 2; Ho = 18,
# Wo = 130: BN-pool one column pair past a strip (Wo % 8 = 2, the scalar
# walk) and one window row past a unit; Wo = 136: 8 columns past a strip
# (the 16-byte walk); Ho = 34, Wo = 264: two strips and 8 columns, two
# units and a window row.
FORWARD_EDGE_SHAPES = [(1, 3, 20, 68), (1, 3, 32, 80), (2, 3, 12, 132),
                       (1, 3, 36, 260), (1, 3, 36, 272), (1, 3, 68, 528)]


@pytest.mark.gpu
@pytest.mark.parametrize("inputs", ["isp", "random"])
@pytest.mark.parametrize("shape", FORWARD_EDGE_SHAPES, ids=str)
def test_stem_bf16_forms_at_the_forward_tile_and_strip_edges(
        shape, inputs, cuda):  # noqa: F811
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, shape, inputs)
    for name, (stats, ok) in stem_bf16_agreement(
            x, w, gamma, beta, inputs == "random").items():
        assert ok, (name, stats)


def _sass_by_kernel(path):
    """{mangled kernel name: its SASS} of a built library."""
    tool = (shutil.which("cuobjdump")
            or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cuobjdump"))
    if not os.path.exists(tool):
        pytest.skip("cuobjdump not found")
    out = subprocess.run([tool, "-sass", path], check=True,
                         capture_output=True, text=True).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", out, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


@pytest.mark.gpu
def test_bf16_dw_and_dx_run_on_tensor_cores(cuda):  # noqa: F811
    """Every instance of the bfloat16 dW and d_x kernels holds tensor-core
    MMAs (HMMA or HGMMA) in the built library's SASS; their float32 forms
    hold none (TF32 would break the float32 contract)."""
    load("stem")
    sass = _sass_by_kernel(library_path("stem"))
    mma = re.compile(r"\bH(G)?MMA\b")

    def bodies(key):
        found = [text for name, text in sass.items() if key in name]
        assert found, (key, sorted(sass))
        return found

    for key in ("stem_conv_dw_mma_kernel", "stem_conv_dx_mma_kernel"):
        assert all(mma.search(text) for text in bodies(key)), key
    for key in ("stem_conv_dw_kernelIf", "stem_conv_dx_kernelIf"):
        assert not any(mma.search(text) for text in bodies(key)), key


@pytest.mark.gpu
def test_bf16_conv_forward_runs_on_tensor_cores(cuda):  # noqa: F811
    """The bfloat16 conv forward's kernel holds tensor-core MMAs in the
    built library's SASS; the float32 conv forward holds none."""
    load("stem")
    sass = _sass_by_kernel(library_path("stem"))
    mma = re.compile(r"\bH(G)?MMA\b")
    for key, want in (("stem_conv_fwd_mma_kernel", True),
                      ("stem_conv_fwd_kernelIf", False)):
        found = [text for name, text in sass.items() if key in name]
        assert found, (key, sorted(sass))
        assert all(bool(mma.search(text)) == want for text in found), key


@pytest.mark.gpu
def test_stem_bf16_functions_repeat_bitwise(cuda):  # noqa: F811
    """stem_train in bfloat16 (values and every gradient) and stem_eval:
    two calls on the same inputs are bitwise equal."""
    w, gamma, beta = stem_params(cuda)
    x = stem_input(cuda, (8, 3, 128, 128), "random")
    runs = []
    for _ in range(2):
        args = [t.clone().requires_grad_(True) for t in (x, w, gamma, beta)]
        pooled, mean, var = stem_train(*args, dtype=torch.bfloat16)
        assert pooled.dtype == torch.bfloat16
        grads = torch.autograd.grad(pooled.float().square().sum(), args)
        assert all(g.dtype == torch.float32 for g in grads)
        with torch.no_grad():
            ev = stem_eval(x, w, gamma, beta, mean, var,
                           dtype=torch.bfloat16)
        runs.append([pooled, mean, var, ev, *grads])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_bf16_resnet_launches_the_bf16_forms(cuda):  # noqa: F811
    """``ResNet(stem_kernel=True, dtype=bfloat16)``: a train-mode forward
    and backward launches each bfloat16 form once and no float32 form;
    an eval call under no_grad launches the two forward forms; its logits
    are float32 and meet JAX's bfloat16 contract against the float32
    ResNet with the plain stem on the same weights."""
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(8, 3, 64, 64, device=cuda, generator=gen)
    model = ResNet(stage_sizes=(1, 1), num_classes=9, device=cuda,
                   stem_kernel=True, dtype=torch.bfloat16)
    ref = ResNet(stage_sizes=(1, 1), num_classes=9, device=cuda,
                 stem_kernel=False)
    ref.load_state_dict(model.state_dict())
    xg = x.clone().requires_grad_(True)
    seen = launched(lambda: model.train()(xg).square().sum().backward())
    assert seen == [(0, 1)] * 5
    assert xg.grad.dtype == torch.float32
    assert model.conv1.weight.grad.dtype == torch.float32
    model.load_state_dict(ref.state_dict())
    with torch.no_grad():
        out = {}
        seen = launched(lambda: out.update(got=model.eval()(x)))
        want = ref.eval()(x)
    assert seen == [(0, 1), (0, 1), (0, 0), (0, 0), (0, 0)]
    assert out["got"].dtype == torch.float32
    med, mx, agree = drift(out["got"], want)
    assert med < BF16_DRIFT_MEDIAN and mx < BF16_DRIFT_MAX, (med, mx)
    assert agree >= BF16_ARGMAX


@pytest.mark.gpu
def test_stem_bf16_forms_check_their_input(cuda):  # noqa: F811
    w, gamma, beta = stem_params(cuda)
    x = torch.randn(2, 3, 32, 32, device=cuda)
    with pytest.raises(NotImplementedError):
        stem_conv(x, w, dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        stem_conv(x.bfloat16(), w)  # x stays float32
    act, _, _ = stem_conv(x, w, dtype=torch.bfloat16)
    assert act.dtype == torch.bfloat16
    pooled = stem_bnpool(act, gamma, beta)
    assert pooled.dtype == torch.bfloat16
    with pytest.raises(ValueError):  # planes of two dtypes
        stem_pool_bwd(act, pooled.float(), gamma, beta, beta, gamma)
    with pytest.raises(NotImplementedError):  # float32 coefficients only
        stem_bnpool(act, gamma.bfloat16(), beta)
    coef = (gamma, beta, beta, beta, gamma)
    with pytest.raises(ValueError):
        stem_conv_dw(x, act, act.float(), coef)
    with pytest.raises(ValueError):
        stem_conv_dx(act, act.transpose(2, 3), coef, w)
