"""Image signal processors (raw mosaic -> planar RGB)."""

from raw2logit_tpu_torch.isp.batchnorm import TorchBatchNorm  # noqa: F401
from raw2logit_tpu_torch.isp.identity import RawToRGB  # noqa: F401
from raw2logit_tpu_torch.isp.neural import NNProcessing  # noqa: F401
from raw2logit_tpu_torch.isp.parametrized import (  # noqa: F401
    ParametrizedProcessing, default_camera_params)
from raw2logit_tpu_torch.isp.static import (  # noqa: F401
    StaticPipeline, static_process)

# the stage names of the tracked-stage contract (``stages`` dicts, the
# tracking module's images)
STAGE_NAMES = ["demosaic", "color_correct", "sharpening", "gaussian",
               "clipped", "gamma_correct", "noise", "rgb"]
