"""The system under test: the port (``raw2logit_tpu_torch``), built the
way its training CLI and its ``Predictor`` build it. With the task-model
builders (``builders/<kind>.py``) this is the only module of the
benchmark that imports the port; the benchmark takes from it the modules,
the train step, the predictor and the kernels' launch counters, and hands
it the seeded weights and inputs.
"""

from h100_bench import spec
from raw2logit_tpu_torch.isp import ParametrizedProcessing
from raw2logit_tpu_torch.kernels import (fused_isp, fused_isp_bwd,
                                         fused_isp_train, ssim_aux_value_grad,
                                         stem_bnpool, stem_conv, stem_conv_dw,
                                         stem_conv_dx, stem_pool_bwd)
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
             "ssim_aux": (ssim_aux_value_grad, "launches"),
             "stem_conv_fwd": (stem_conv, "launches"),
             "stem_bnpool": (stem_bnpool, "launches"),
             "stem_pool_bwd": (stem_pool_bwd, "launches"),
             "stem_conv_dw": (stem_conv_dw, "launches"),
             "stem_conv_dx": (stem_conv_dx, "launches")}


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
    """The task model as the CLI builds it, by the builder of the
    configuration's model kind (``spec.model_builder``)."""
    model = config["model"]
    return spec.model_builder(model["kind"]).build(model, device)


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
