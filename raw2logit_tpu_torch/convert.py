"""Carry weights across from the JAX package.

The functions take the JAX package's variables as nested dicts of numpy
arrays (``{"params": ..., "batch_stats": ...}``, e.g. from
``jax.device_get``) and return state dicts for the port's modules.
"""

import numpy as np
import torch


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a copy


def isp_state_dict(variables):
    """``ParametrizedProcessing`` variables -> the port's state dict
    (debayer HWIO -> OIHW, filters (k, k) -> (1, 1, k, k), additive layer
    NHWC -> NCHW, batch-norm statistics -> running buffers)."""
    p = variables["params"]
    sd = {
        "black_level": _t(p["black_level"]),
        "white_balance": _t(p["white_balance"]),
        "colour_correction": _t(p["colour_correction"]),
        "gamma_correct": _t(p["gamma_correct"]),
        "sharpening_filter.weight": _t(p["sharpening_filter"])[None, None],
        "gaussian_blur.weight": _t(p["gaussian_blur"])[None, None],
        "debayer.weight": _t(np.transpose(p["debayer"], (3, 2, 0, 1))),
    }
    if "additive_layer" in p:
        sd["additive_layer"] = _t(np.transpose(p["additive_layer"],
                                               (0, 3, 1, 2)))
    bn = variables.get("batch_stats", {}).get("batch_norm")
    if bn is not None:
        sd["batch_norm.running_mean"] = _t(bn["mean"])
        sd["batch_norm.running_var"] = _t(bn["var"])
        sd["batch_norm.num_batches_tracked"] = torch.tensor(0)
    return sd


def resnet_name(flax_path):
    """flax module path -> torchvision-style name: conv_init -> conv1,
    bn_init -> bn1, layer{i}_{j} -> layer{i}.{j}, Conv_k -> conv{k+1},
    BatchNorm_k -> bn{k+1}, downsample_conv/_bn -> downsample.0/.1."""
    names = []
    for part in flax_path:
        if part == "conv_init":
            names.append("conv1")
        elif part == "bn_init":
            names.append("bn1")
        elif part.startswith("layer"):
            stage, block = part[len("layer"):].split("_")
            names.append(f"layer{stage}.{block}")
        elif part.startswith("Conv_"):
            names.append(f"conv{int(part[5:]) + 1}")
        elif part.startswith("BatchNorm_"):
            names.append(f"bn{int(part[10:]) + 1}")
        elif part == "downsample_conv":
            names.append("downsample.0")
        elif part == "downsample_bn":
            names.append("downsample.1")
        else:
            names.append(part)
    return ".".join(names)


def _walk(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def resnet_state_dict(variables):
    """flax ``ResNet`` variables -> the port's ``ResNet`` state dict (conv
    HWIO -> OIHW, Dense kernel (in, out) -> Linear weight (out, in),
    BN scale/bias/mean/var -> weight/bias/running_mean/running_var).
    Modules whose names ``resnet_name`` keeps map by the same rules, so
    it also carries the models built around a ResNet (below)."""
    sd = {}
    for path, a in _walk(variables["params"]):
        name, leaf = resnet_name(path[:-1]), path[-1]
        if leaf == "kernel":
            a = (np.transpose(a, (3, 2, 0, 1)) if np.ndim(a) == 4
                 else np.transpose(a))
            sd[f"{name}.weight"] = _t(a)
        elif leaf == "scale":
            sd[f"{name}.weight"] = _t(a)
        elif leaf == "bias":
            sd[f"{name}.bias"] = _t(a)
        else:
            raise KeyError(f"unexpected ResNet parameter {'/'.join(path)}")
    for path, a in _walk(variables.get("batch_stats", {})):
        name = resnet_name(path[:-1])
        sd[f"{name}.running_{path[-1]}"] = _t(a)  # mean, var
        sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return sd



# flax ``UNetPlusPlus`` (encoder under ``encoder/``, decoder nodes
# ``x_i_j/conv{k}``, ``bn{k}``, ``segmentation_head``) and ``NNProcessing``
# (the U-Net++ under ``model/``, the output batch norm's statistics under
# ``batch_norm``) keep the port's names, so the ResNet mapping carries both
unetpp_state_dict = nn_isp_state_dict = resnet_state_dict
