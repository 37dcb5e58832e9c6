"""The yardstick's arithmetic: published peaks, the bytes and operations
of each of the port's kernels, and the model FLOPs of a step.

``PEAKS`` and ``KERNEL_COST`` are frozen copies of the tables in
``chip_smoke.py`` (kept here so that no later change to the program moves
the yardstick). ``KERNEL_PATTERNS`` are the patterns that find each
kernel's records in a profiler trace (template instances of
``raw2logit_tpu_torch/csrc/*.cu``). The model FLOPs are counted from the
shapes alone, each model kind's MACs by its reference file
(``reference/kinds/<kind>.py``): a conv or linear layer does 2 * MACs in
the forward, as many again for its input gradient, and as many again for
its weight gradient where those weights train; batch norms, activations,
pools and the optimizer are not counted, and recomputed work never is.
"""

import re

from h100_bench import spec

# Published peaks (NVIDIA data sheets): device-memory bytes/s, non-tensor
# float32 operations/s and dense bfloat16 tensor-core operations/s; the
# first name found in the device's name wins.
PEAKS = (("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H200", 4.8e12, 67e12, 989e12),
         ("H100", 3.35e12, 67e12, 989e12))

# Bytes each kernel must move and float32 operations it must do, per
# pixel of (B, H, W) (per element of (B, 3, H, W) for ssim_aux); an FMA is
# 2 operations, a transcendental 1. chip_smoke.py's comment block derives
# each figure.
KERNEL_COST = {"fused_isp_fwd": (16, 174), "fused_isp_fwd_train": (36, 174),
               "fused_isp_bwd_res": (40, 386), "fused_isp_bwd": (20, 515),
               "ssim_aux": (12, 396), "stem_conv_fwd": (4.75, 297),
               "stem_bnpool": (5, 5), "stem_pool_bwd": (9, 12),
               "stem_conv_dw": (8.75, 300), "stem_conv_dx": (8.75, 300)}

# Which elements a kernel's cost is counted over: "pixels" of (B, H, W),
# "rgb" elements of (B, 3, H, W), "act" elements of the stem's
# (B, 64, H/2, W/2).
KERNEL_UNIT = {"fused_isp_fwd": "pixels", "fused_isp_fwd_train": "pixels",
               "fused_isp_bwd_res": "pixels", "fused_isp_bwd": "pixels",
               "ssim_aux": "rgb", "stem_conv_fwd": "act",
               "stem_bnpool": "act", "stem_pool_bwd": "act",
               "stem_conv_dw": "act", "stem_conv_dx": "act"}

KERNEL_PATTERNS = {"fused_isp_fwd": r"fused_isp_fwd_kernel<false,",
                   "fused_isp_fwd_train": r"fused_isp_fwd_kernel<true,",
                   "fused_isp_bwd_res": r"fused_isp_bwd_kernel<true>",
                   "fused_isp_bwd": r"fused_isp_bwd_kernel<false>",
                   "ssim_aux": r"ssim_aux_kernel",
                   **{name: rf"{name}_kernel<[^>]*float>"
                      for name in ("stem_conv_fwd", "stem_bnpool",
                                   "stem_pool_bwd", "stem_conv_dw",
                                   "stem_conv_dx")}}


def peaks(kind):
    """(name, bytes/s, float32 operations/s) of the device called
    ``kind``; None for a device the table does not know."""
    for name, bw, ops, _ in PEAKS:
        if name in kind:
            return name, bw, ops
    return None


def port_kernel(record_name):
    """The ``KERNEL_COST`` key of a trace record's name, or None for a
    kernel that is not the port's own."""
    for name, pattern in KERNEL_PATTERNS.items():
        if re.search(pattern, record_name):
            return name
    return None


def kernel_elements(kernel, batch, height, width):
    """The elements a launch of ``kernel`` covers on a (batch, height,
    width) mosaic batch."""
    unit = KERNEL_UNIT[kernel]
    if unit == "pixels":
        return batch * height * width
    if unit == "rgb":
        return 3 * batch * height * width
    return 64 * batch * (height // 2) * (width // 2)


def kernel_bound_s(kernel, elements, kind):
    """Least seconds ``kernel`` can take over ``elements`` on the device
    called ``kind``: the larger of its bytes over the memory peak and its
    operations over the float32 peak."""
    _, bw, ops = peaks(kind)
    bytes_pe, ops_pe = KERNEL_COST[kernel]
    return max(elements * bytes_pe / bw, elements * ops_pe / ops)


def model_macs(config):
    """MACs per image of the configuration's task model at its image
    size, as its model kind counts them (``reference/kinds/<kind>.py``)."""
    model, size = config["model"], config["image_size"]
    return spec.model_kind(model["kind"]).macs(model, size, size)


def isp_ops(config, kernels):
    """Float32 operations per image of the ISP and SSIM kernels named in
    ``kernels`` (their ``KERNEL_COST`` operations)."""
    size = config["image_size"]
    return sum(KERNEL_COST[k][1] * kernel_elements(k, 1, size, size)
               for k in kernels)


def step_flops(config, traffic):
    """Model FLOPs of one step (or one served batch) of ``traffic``'s
    batch: the task model's forward (2 * MACs), its input gradient in a
    train step (the ISP upstream trains, so it is needed down to the
    input), its weight gradient where the task model trains; and the
    ISP's and SSIM's kernel operations as ``traffic`` runs them."""
    macs = model_macs(config)
    kind, batch = traffic["kind"], traffic["batch"]
    if kind == "serve":
        return batch * (2 * macs + isp_ops(config, ["fused_isp_fwd"]))
    adversarial = traffic.get("adversarial", False)
    model = 2 * macs * (2 if adversarial else 3)
    isp = ["fused_isp_fwd_train", "fused_isp_bwd_res"]
    if adversarial:
        isp += ["fused_isp_fwd", "ssim_aux"]
    return batch * (model + isp_ops(config, isp))
