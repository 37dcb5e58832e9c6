"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor, and counts its launches in an integer
attribute (``fused_isp.launches``, ``fused_isp_train.launches``,
``fused_isp_bwd.launches_res``, ``fused_isp_bwd.launches`` and
``ssim_aux_value_grad.launches``). ``FusedISP`` pairs the training
forward with the backward kernel; ``SSIMAux`` wraps the SSIM aux
kernel's value and gradient.
"""

from raw2logit_tpu_torch.kernels.fused_isp import (  # noqa: F401
    PARAM_NAMES, FusedISP, fused_isp, fused_isp_autograd,
    fused_isp_reference, fused_isp_train, fused_isp_train_reference,
    isp_from_packed, pack_params)
from raw2logit_tpu_torch.kernels.fused_isp_bwd import (  # noqa: F401
    fused_isp_bwd, fused_isp_bwd_reference, unpack_grads)
from raw2logit_tpu_torch.kernels.ssim_aux import (  # noqa: F401
    SSIMAux, ssim_aux_reference, ssim_aux_value_grad)
