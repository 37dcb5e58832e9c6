"""Model kind ``resnet``: the port's ResNet classifier as the training CLI
builds it (``resnet_model``; ``stem_kernel`` left at its default, so the
classifier path runs the port's fused stem kernels wherever they take the
input)."""

from raw2logit_tpu_torch.models import resnet_model


def build(model, device):
    return resnet_model(model=model["arch"],
                        fc_out_features=model["num_classes"], device=device)
