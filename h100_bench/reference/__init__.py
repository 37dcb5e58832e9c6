"""The plain reference that decides ``correct``: the parametrized ISP,
the ResNet and U-Net++ task models, the losses, SSIM and Adam, written in
plain PyTorch over dicts of tensors. It imports neither JAX nor the JAX
package nor anything of the port (``raw2logit_tpu_torch``); its model
code is a frozen copy of the port's plain math, so that a later change to
the program cannot move it.

Every convolution and matrix product goes through ``ops.conv2d`` and
``ops.linear``. With ``tf32=True`` they round their operands (and, in the
backward, the output cotangent) to TF32's 10-bit mantissa, on any device:
that is the control, the reference computed in the nearest precision
below the configuration's float32.
"""
