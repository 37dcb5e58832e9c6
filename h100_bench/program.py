"""The system under test: the port (``raw2logit_tpu_torch``), built the
way its training CLI and its ``Predictor`` build it. This is the only
module of the benchmark that imports the port; the benchmark takes from
it the modules, the train step, the predictor and the kernels' launch
counters, and hands it the seeded weights and inputs.
"""

from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.kernels import (fused_isp, fused_isp_bwd,
                                         fused_isp_train, ssim_aux_value_grad)
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet_model
from raw2logit_tpu_torch.serving import Predictor
from raw2logit_tpu_torch.training.core import (TrainConfig,
                                               create_train_state,
                                               make_train_step)

# the port's launch counters of the kernels these cells can run, by the
# names of ``costs.KERNEL_COST``
_COUNTERS = {"fused_isp_fwd": (fused_isp, "launches"),
             "fused_isp_fwd_train": (fused_isp_train, "launches"),
             "fused_isp_bwd_res": (fused_isp_bwd, "launches_res"),
             "fused_isp_bwd": (fused_isp_bwd, "launches"),
             "ssim_aux": (ssim_aux_value_grad, "launches")}


def launches():
    """{kernel: launches so far} of the port's kernels."""
    return {name: getattr(fn, attr, 0) for name, (fn, attr)
            in _COUNTERS.items()}


def build_isp(config, traffic, device):
    """The parametrized ISP on the fused kernels (``--use_pallas``), with
    the additive noise layer in adversarial mode (``--adv_noise_layer``)."""
    return ParametrizedProcessing(
        camera_parameters=tuple(config["camera"][k] for k in
                                ("black_level", "white_balance",
                                 "colour_matrix")),
        batch_norm_output=True,
        additive_layer=traffic.get("adversarial", False),
        image_size=config["image_size"], use_kernel=config["use_kernel"],
        device=device)


def build_model(config, device):
    """The task model as the CLI builds it (cuDNN's stem: no flag of the
    CLI reaches the stem kernels)."""
    m = config["model"]
    if m["kind"] == "resnet":
        return resnet_model(model=m["arch"], fc_out_features=m["num_classes"],
                            device=device)
    return UNetPlusPlus(encoder_name=m["encoder"],
                        encoder_depth=len(m["decoder_channels"]),
                        decoder_channels=tuple(m["decoder_channels"]),
                        in_channels=3, classes=m["classes"], device=device)


def train_config(config, traffic):
    """The ``TrainConfig`` the CLI builds for this traffic."""
    adversarial = traffic.get("adversarial", False)
    return TrainConfig(
        task=config["task"], lr=traffic["lr"],
        freeze_classifier=adversarial, adv_training=adversarial,
        adv_aux_weight=traffic.get("aux_weight", 1.0), adv_aux_loss="ssim",
        adv_parameters="all", loss_weight=traffic["loss_weight"])


def make_state_and_step(config, traffic, processor, model):
    """The train state over the two modules as they are now (in
    adversarial mode its reference ISP is a copy of ``processor``), and
    the one train step."""
    cfg = train_config(config, traffic)
    return create_train_state(cfg, processor, model), make_train_step(
        cfg, processor, model)


def predictor(processor, model, config, device):
    """The port's ``Predictor`` over the two modules."""
    return Predictor(processor, model, task=config["task"], device=device)
