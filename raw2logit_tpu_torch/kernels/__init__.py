"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch version on a CPU tensor, and counts its launches in an integer
attribute (``fused_isp.launches``, ``fused_isp_train.launches``,
``fused_isp_bwd.launches_res``, ``fused_isp_bwd.launches``,
``ssim_aux_value_grad.launches``, and the stem's ``stem_conv``,
``stem_bnpool``, ``stem_pool_bwd``, ``stem_conv_dw`` and ``stem_conv_dx``
``.launches``, with ``.launches_bf16`` for their bfloat16 forms). ``FusedISP`` pairs the training forward with the backward
kernel; ``SSIMAux`` wraps the SSIM aux kernel's value and gradient;
``StemTrain`` runs the stem's forward kernels and its three backward
kernels.
"""

from raw2logit_tpu_torch.kernels.fused_isp import (  # noqa: F401
    PARAM_NAMES, FusedISP, fused_isp, fused_isp_autograd,
    fused_isp_reference, fused_isp_train, fused_isp_train_reference,
    isp_from_packed, pack_params)
from raw2logit_tpu_torch.kernels.fused_isp_bwd import (  # noqa: F401
    fused_isp_bwd, fused_isp_bwd_reference, unpack_grads)
from raw2logit_tpu_torch.kernels.ssim_aux import (  # noqa: F401
    SSIMAux, ssim_aux_reference, ssim_aux_value_grad)
from raw2logit_tpu_torch.kernels.stem import (  # noqa: F401
    StemTrain, batch_stats, bn_backward_coef, bn_fold, bn_input_cotangent,
    stem_bnpool, stem_bnpool_reference, stem_conv, stem_conv_dw,
    stem_conv_dw_reference, stem_conv_dx, stem_conv_dx_reference,
    stem_conv_reference, stem_eval, stem_pool_bwd, stem_pool_bwd_reference,
    stem_reference, stem_train, window_taps)
