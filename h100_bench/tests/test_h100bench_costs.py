"""The model FLOPs of ``costs.py`` against torch's own FLOP counter on
the reference models, and the kernels' bounds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import costs, data
from h100_bench.reference.models import model_forward, model_spec
from h100_bench.tests import tiny

SIZE = 64
# the cells' task models, and ResNet-50 as a classifier and as the
# U-Net++ encoder in their configurations' place
RESNET50 = {"kind": "resnet", "arch": "resnet50", "num_classes": 9}
UNETPP_RESNET50 = {"kind": "unetpp", "encoder": "resnet50",
                   "decoder_channels": [256, 128, 64, 32, 16], "classes": 1}
MODELS = {"cls_train": ("cls_train", None), "seg_train": ("seg_train", None),
          "resnet50": ("cls_train", RESNET50),
          "unetpp_resnet50": ("seg_train", UNETPP_RESNET50)}


def _config(name):
    cell, model = MODELS[name]
    config = dict(tiny.cell(cell).config, image_size=SIZE)
    return config if model is None else dict(config, model=model)


def _counted(config, batch, train_weights, input_grad):
    model = config["model"]
    p = data.weights(model_spec(model), 1, torch.device("cpu"))
    for k, v in p.items():
        if v.is_floating_point() and not k.endswith(("running_mean",
                                                     "running_var")):
            v.requires_grad_(train_weights)
    x = torch.rand(batch, 3, SIZE, SIZE, requires_grad=input_grad)
    with FlopCounterMode(display=False) as counter:
        out = model_forward(model, p, x, True)
        if train_weights or input_grad:
            out.sum().backward()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_flops_match_torchs_counter(name):
    config = _config(name)
    assert (_counted(config, 2, False, False)
            == 2 * 2 * costs.model_macs(config))


@pytest.mark.parametrize("name", list(MODELS))
def test_train_flops_are_three_forwards(name):
    config = _config(name)
    assert (_counted(config, 2, True, True)
            == 3 * 2 * 2 * costs.model_macs(config))


def test_frozen_model_flops_are_two_forwards():
    config = dict(tiny.cell("cls_forensics").config, image_size=SIZE)
    assert (_counted(config, 2, False, True)
            == 2 * 2 * 2 * costs.model_macs(config))


def test_step_flops_add_the_isp_and_ssim_kernels():
    cell = tiny.cell("cls_forensics")
    config, traffic = cell.config, dict(cell.traffic, batch=3)
    macs = costs.model_macs(config)
    pixels = SIZE * SIZE
    isp = (174 + 386 + 174) * pixels + 396 * 3 * pixels
    assert costs.step_flops(config, traffic) == 3 * (4 * macs + isp)
    joint = dict(traffic, adversarial=False)
    assert costs.step_flops(config, joint) == 3 * (
        6 * macs + (174 + 386) * pixels)
    serve = {"kind": "serve", "batch": 3}
    assert costs.step_flops(config, serve) == 3 * (2 * macs + 174 * pixels)


def _macs(model, size):
    return costs.model_macs({"image_size": size, "model": model})


def test_resnet18_at_224_is_the_published_count():
    # ResNet-18 at 224x224: 1.81 GMACs (He et al.; torchvision's 1.81)
    macs = _macs({"kind": "resnet", "arch": "resnet18", "num_classes": 1000},
                 224)
    assert 1.80e9 < macs < 1.83e9


@pytest.mark.parametrize("size,classes,macs", [(224, 1000, 4_089_184_256),
                                               (256, 9, 5_338_318_848)])
def test_resnet50_is_the_published_count(size, classes, macs):
    # ResNet-50 at 224x224: torchvision's published 4.09 GMACs
    model = dict(RESNET50, num_classes=classes)
    assert _macs(model, size) == macs


def test_the_cells_model_macs_stand():
    # step_mfu of the four cells reads as it did before the model kinds
    assert costs.model_macs(tiny.cell("cls_train").config
                            | {"image_size": 256}) == 2_368_737_792
    assert costs.model_macs(tiny.cell("seg_train").config
                            | {"image_size": 256}) == 17_166_237_696


def test_kernel_bounds_and_names():
    kind = "NVIDIA H100 80GB HBM3"
    assert costs.peaks(kind)[1:] == (3.35e12, 67e12)
    assert costs.peaks("NVIDIA H100 PCIe")[2] == 51e12
    n = costs.kernel_elements("fused_isp_bwd_res", 256, 256, 256)
    assert n == 256 * 256 * 256
    # 386 operations and 40 bytes a pixel: the bytes bound it
    assert costs.kernel_bound_s("fused_isp_bwd_res", n, kind) == \
        pytest.approx(n * 40 / 3.35e12)
    # 396 operations and 12 bytes an element: the operations bound it
    assert costs.kernel_bound_s("ssim_aux", 10, kind) == \
        pytest.approx(10 * 396 / 67e12)
    assert costs.kernel_elements("ssim_aux", 2, 8, 8) == 3 * 2 * 8 * 8
    assert costs.port_kernel("void fused_isp_fwd_kernel<true, true>("
                             "float const*)") == "fused_isp_fwd_train"
    assert costs.port_kernel("fused_isp_bwd_kernel<true>") == \
        "fused_isp_bwd_res"
    assert costs.port_kernel("ssim_aux_kernel(float const*)") == "ssim_aux"
    assert costs.port_kernel("cudnn::winograd_nonfused") is None
