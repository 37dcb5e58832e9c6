"""Model kind ``unetpp``: the port's U-Net++ as the training CLI builds it
(its encoder's features path runs the plain stem)."""

from raw2logit_tpu_torch.models import UNetPlusPlus


def build(model, device):
    return UNetPlusPlus(encoder_name=model["encoder"],
                        encoder_depth=len(model["decoder_channels"]),
                        decoder_channels=tuple(model["decoder_channels"]),
                        in_channels=3, classes=model["classes"],
                        device=device)
