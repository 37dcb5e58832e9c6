"""ImageNet-weight overlays in the PyTorch port (``models/resnet.py``:
``load_pretrained_npz``, ``overlay_pretrained``,
``load_pretrained_variables``, ``PRETRAINED_SKIP``), mirroring
``tests/test_pretrained.py``: the backbone applied with the stem and the
head kept, a missing file, a shape mismatch, an unknown key, the U-Net++
encoder's prefix (full stem), the truncated encoder of the neural ISP,
and the training CLI end to end (``--classifier_pretrained``, the
segmentation encoder, the neural ISP's encoder). Parity: one synthesised
npz overlaid by both packages gives the same float32 logits.

The ImageNet weights are not in the repository; every npz here is
synthesised in the converter's flat flax-path layout
(``params/layer1_0/Conv_0/kernel``), from a flax variable tree that
``jax.eval_shape`` gives without running an init.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.models import resnet as jresnet

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.data import (SyntheticRawClassification,
                                      SyntheticRawSegmentation)
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet, resnet_model
from raw2logit_tpu_torch.models.resnet import (PRETRAINED_SKIP,
                                               load_pretrained_variables,
                                               overlay_pretrained)
from raw2logit_tpu_torch.training import train as cli
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401

# float32 logits of the same overlaid weights in two frameworks,
# relative to max(1, |logit|); measured 6e-7 on the CPU
LOGIT_TOL = 1e-5
# a parameter after one Adam step at the CLI's default lr (1e-5) from its
# overlaid value moves by at most about lr
ONE_STEP_TOL = 1e-4


@functools.cache
def flax_shapes(model, classes=4):
    """{flax path: shape} of the flax ``resnet_model(model)``'s variables
    (no init runs)."""
    net = jresnet.resnet_model(model, fc_out_features=classes)
    tree = jax.eval_shape(functools.partial(net.init, train=False),
                          jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    return {"/".join(p.key for p in path): s.shape for path, s in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def synthesise(shapes, seed=7, drop=("fc",)):
    """A converter-layout npz dict of realistic values (kernels N(0,
    1 / fan_in), BN scales U(0.5, 1.5), running variances U(0.5, 2),
    biases and means N(0, 0.1)), without the entries under ``drop`` (the
    converter writes everything but fc)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in shapes.items():
        if key.split("/")[1] in drop:
            continue
        leaf = key.split("/")[-1]
        if leaf == "kernel":
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf == "scale":
            a = rng.uniform(0.5, 1.5, shape)
        elif leaf == "var":
            a = rng.uniform(0.5, 2.0, shape)
        else:
            a = rng.normal(0.0, 0.1, shape)
        flat[key] = a.astype(np.float32)
    return flat


def write_npz(directory, model, flat):
    os.makedirs(directory, exist_ok=True)
    np.savez(os.path.join(directory, f"{model}.npz"), **flat)


def port_tensor(module, key, prefix=()):
    """The port's tensor for a flax path, in the flax layout."""
    coll, *path = key.split("/")
    name = convert.resnet_name(tuple(prefix) + tuple(path[:-1]))
    sub = module.get_submodule(name)
    leaf = path[-1]
    attr = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}[leaf]
    t = getattr(sub, attr).detach().numpy()
    if leaf == "kernel":
        t = np.transpose(t, (2, 3, 1, 0)) if t.ndim == 4 else t.T
    return t


def test_overlay_applies_backbone_keeps_stem_conv_and_head(tmp_path):
    flat = synthesise(flax_shapes("resnet18"))
    write_npz(tmp_path, "resnet18", flat)
    model = resnet_model("resnet18", fc_out_features=4, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    applied = load_pretrained_variables("resnet18", model,
                                        weights_dir=str(tmp_path))
    n_backbone = 0
    for key, value in flat.items():
        if key.split("/")[1] in PRETRAINED_SKIP:
            assert key not in applied
            continue
        np.testing.assert_array_equal(port_tensor(model, key), value)
        n_backbone += 1
    assert n_backbone == len(applied) > 80
    # conv1 (conv_init) and the head keep their init (bn1, bn_init, is
    # overlaid, as in JAX)
    for name in ("conv1.weight", "fc.weight", "fc.bias"):
        torch.testing.assert_close(model.state_dict()[name], before[name],
                                   atol=0, rtol=0)


def test_missing_weights_raise(tmp_path):
    nope = str(tmp_path / "nope")
    with pytest.raises(FileNotFoundError):
        resnet_model("resnet18", pretrained=True, weights_dir=nope,
                     device="cpu")
    model = resnet_model("resnet18", device="cpu")
    with pytest.raises(FileNotFoundError):
        load_pretrained_variables("resnet18", model, weights_dir=nope)
    # best-effort mode leaves the module as it is
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrained_variables("resnet18", model, weights_dir=nope,
                                     required=False) == []
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, before[k], atol=0, rtol=0)


@functools.cache
def plain_resnet18():
    return resnet_model("resnet18", device="cpu")


@pytest.mark.parametrize("flat,err,match", [
    ({"params/layer1_0/Conv_0/kernel": np.zeros((1, 1, 1, 1), np.float32)},
     ValueError, "shape mismatch"),
    ({"params/not_a_layer/kernel": np.zeros((1,), np.float32)},
     KeyError, "not_a_layer"),
    ({"params/layer1_0/Conv_0/gamma": np.zeros((1,), np.float32)},
     KeyError, "gamma"),
    ({"cache/layer1_0/Conv_0/kernel": np.zeros((1,), np.float32)},
     KeyError, "cache"),
], ids=["shape", "module", "leaf", "collection"])
def test_overlay_is_strict(flat, err, match):
    with pytest.raises(err, match=match):
        overlay_pretrained(plain_resnet18(), flat)


def encoder_npz(model, seed=7):
    """A full classifier's npz (no fc), as the converter writes it for an
    encoder's weights."""
    return synthesise(flax_shapes(model), seed)


def test_unetpp_encoder_prefix_overlay_loads_the_full_stem(tmp_path):
    flat = encoder_npz("resnet18")
    write_npz(tmp_path, "resnet18", flat)
    net = UNetPlusPlus(encoder_name="resnet18", encoder_depth=5,
                       decoder_channels=(64, 32, 16, 16, 16), classes=1,
                       device="cpu")
    decoder = {k: v.clone() for k, v in net.state_dict().items()
               if not k.startswith("encoder")}
    applied = load_pretrained_variables("resnet18", net,
                                        weights_dir=str(tmp_path),
                                        prefix=("encoder",))
    for key, value in flat.items():
        np.testing.assert_array_equal(
            port_tensor(net, key, prefix=("encoder",)), value)
    assert len(applied) == len(flat)
    assert any("conv_init" in k for k in applied)  # the stem is loaded
    for k, v in decoder.items():
        torch.testing.assert_close(net.state_dict()[k], v, atol=0, rtol=0)


def test_truncated_encoder_needs_ignore_missing(tmp_path):
    """The neural ISP's depth-3 resnet34 encoder has only layer1 and
    layer2: a full resnet34 npz applies with ``ignore_missing`` and raises
    without it."""
    write_npz(tmp_path, "resnet34", encoder_npz("resnet34"))
    net = UNetPlusPlus(encoder_name="resnet34", encoder_depth=3,
                       decoder_channels=(64, 32, 16), classes=3,
                       device="cpu")
    with pytest.raises(KeyError):
        load_pretrained_variables("resnet34", net, weights_dir=str(tmp_path),
                                  prefix=("encoder",))
    applied = load_pretrained_variables(
        "resnet34", net, weights_dir=str(tmp_path), prefix=("encoder",),
        ignore_missing=True)
    assert applied
    assert all("layer3" not in k and "layer4" not in k for k in applied)


def test_one_npz_gives_both_packages_the_same_logits(tmp_path):
    """JAX's overlay and the port's, of one synthesised npz onto the same
    starting weights: eval logits within 1e-5 (float32, measured 6e-7)."""
    shapes = flax_shapes("resnet18")
    base = synthesise(shapes, seed=1, drop=())
    tree = {}
    for key, value in base.items():
        node = tree
        for part in key.split("/")[:-1]:
            node = node.setdefault(part, {})
        node[key.split("/")[-1]] = value
    write_npz(tmp_path, "resnet18", synthesise(shapes, seed=2))
    jax_vars, jax_applied = jresnet.load_pretrained_variables(
        "resnet18", tree, weights_dir=str(tmp_path))
    port = resnet_model("resnet18", fc_out_features=4, device="cpu")
    port.load_state_dict(convert.resnet_state_dict(tree))
    applied = load_pretrained_variables("resnet18", port,
                                        weights_dir=str(tmp_path))
    assert sorted(applied) == sorted(jax_applied)
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jresnet.resnet_model("resnet18", fc_out_features=4)
                      .apply(jax_vars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port.eval()(torch.tensor(np.transpose(x, (0, 3, 1, 2))))
    err = np.abs(got.numpy() - want).max() / max(1.0, np.abs(want).max())
    assert err < LOGIT_TOL, err


# --- the CLI ----------------------------------------------------------------

def run_cli(monkeypatch, dataset, flags):
    monkeypatch.setattr(cli, "get_dataset", lambda name, **kw: dataset)
    (res,) = cli.main(["--epochs", "1", "--batch_size", "4", "--n_splits",
                       "1", "--test_run", "--device", "cpu",
                       "--experiment_name", "pt", "--run_name", "pt1",
                       *flags])
    return res


def assert_one_step_from(module, flat, prefix=()):
    """Every parameter of ``flat`` one Adam step from its value (running
    statistics move by the step's batch, 0.1 of the way)."""
    params = [k for k in flat if k.startswith("params/")]
    assert params
    for key in params:
        got = port_tensor(module, key, prefix)
        assert np.abs(got - flat[key]).max() < ONE_STEP_TOL, key


def test_cli_classifier_pretrained(tmp_path, monkeypatch):
    """--classifier_pretrained: the backbone starts from weights/
    resnet18.npz (one Adam step away after the run), conv1 does not; with
    no file the CLI raises at build."""
    monkeypatch.chdir(tmp_path)
    data = SyntheticRawClassification(n=8, h=64, w=64, seed=5)
    flags = ["--dataset", "SyntheticMicroscopy", "--processing_mode",
             "static", "--classifier_pretrained"]
    with pytest.raises(FileNotFoundError):
        run_cli(monkeypatch, data, flags)
    flat = synthesise(flax_shapes("resnet18", len(data.classes)))
    write_npz("weights", "resnet18", flat)
    res = run_cli(monkeypatch, data, flags)
    clf = res["state"].classifier
    backbone = {k: v for k, v in flat.items()
                if k.split("/")[1] not in PRETRAINED_SKIP}
    assert_one_step_from(clf, backbone)
    stem = "params/conv_init/kernel"
    assert np.abs(port_tensor(clf, stem) - flat[stem]).max() > 0.1


def test_cli_overlays_the_segmentation_encoder(tmp_path, monkeypatch):
    """SyntheticDrone with --smp_encoder resnet18 and weights/resnet18.npz:
    the U-Net++ encoder, stem included, starts from the file."""
    monkeypatch.chdir(tmp_path)
    flat = encoder_npz("resnet18")
    write_npz("weights", "resnet18", flat)
    res = run_cli(monkeypatch,
                  SyntheticRawSegmentation(n=8, h=64, w=64, seed=5),
                  ["--dataset", "SyntheticDrone", "--smp_encoder",
                   "resnet18"])
    assert_one_step_from(res["state"].classifier, flat, ("encoder",))


def test_cli_overlays_the_neural_isp_encoder(tmp_path, monkeypatch):
    """--processing_mode neural_network with weights/resnet34.npz: the
    neural ISP's depth-3 encoder starts from the file's stem, layer1 and
    layer2; the rest of the file is left out."""
    monkeypatch.chdir(tmp_path)
    flat = encoder_npz("resnet34")
    write_npz("weights", "resnet34", flat)
    res = run_cli(monkeypatch,
                  SyntheticRawClassification(n=8, h=64, w=64, seed=5),
                  ["--dataset", "SyntheticMicroscopy", "--processing_mode",
                   "neural_network"])
    early = {k: v for k, v in flat.items()
             if "layer3" not in k and "layer4" not in k}
    assert_one_step_from(res["state"].processor, early, ("model", "encoder"))


def test_resnet_model_builds_in_bfloat16_with_the_stem_flag():
    """The factory passes ``dtype`` and ``stem_kernel`` through; the
    parameters stay float32."""
    model = resnet_model("resnet18", dtype=torch.bfloat16, stem_kernel=True,
                         device="cpu")
    assert model.dtype == torch.bfloat16 and model.stem_kernel
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(NotImplementedError):
        resnet.ResNet(device="cpu", dtype=torch.float16)
