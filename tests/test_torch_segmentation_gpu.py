"""The port's segmentation path and its neural and identity ISPs on the
card, with the gates of ``chip_smoke.py``'s segmentation phases at small
batches: a segmentation train step through the ISP kernels against the
plain ISP (the kernel step's ISP gradients held to the float64 plain
backward on its own cotangent), one training forward and one residual
backward per step; segmentation serving, one serving launch per batch,
masks against the plain ISP's; the neural ISP's float32 against its
float64 self, the identity ISP against the CPU, and a neural-ISP train
step that launches no kernel of the port. Imports no JAX, so that it runs
where the port runs:

    python -m pytest tests/test_torch_segmentation_gpu.py -m gpu

Every test skips where there is no CUDA device.
"""

import pytest
import torch

from chip_smoke import (launches, phase_neural_identity, phase_seg_serve,
                        phase_seg_train)

SIZE = 64


@pytest.fixture
def cuda():
    """The card with TF32 off, as chip_smoke.py runs it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the ISP kernels on the "
                    "segmentation path)")
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


@pytest.mark.gpu
@pytest.mark.parametrize("batch,big,steps", [(2, 4, 2), (3, 2, 1)])
def test_seg_step_kernel_path_against_plain_path(cuda, batch, big, steps):
    """The full-width U-Net++ at 256x256 with small batches; the phase
    raises on a failed gate. (At 64x64 its deepest batch norms normalise
    2x2 positions per image: on an H100 at B = 2 the two paths' U-Net++
    gradients read 1.55e-3 apart, the float32 plain path 1.55e-3 from the
    float64 step and the kernel path 1.4e-4, which the phase's gates,
    each path against float64, also pass.)"""
    main = phase_seg_train(cuda, batch=batch, big=big, steps=steps)
    assert main == launches(fwd_train=steps, bwd_res=steps)


@pytest.mark.gpu
@pytest.mark.parametrize("n_images,batch", [(5, 2), (4, 4)])
def test_seg_serving_launches_once_per_batch(cuda, n_images, batch):
    served = phase_seg_serve(cuda, n_images=n_images, batch=batch,
                             size=SIZE)
    assert served == launches(fwd=-(-n_images // batch))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 3])
def test_neural_and_identity_isps_on_the_card(cuda, batch):
    """B >= 2: at 64x64 ResNet-18's last stage is 1x1, and a train-mode
    batch norm needs more than one value per channel."""
    phase_neural_identity(cuda, batch=batch, size=SIZE)
