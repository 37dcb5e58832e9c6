"""PyTorch port vs the JAX package: the bfloat16 ResNet-18.

JAX's bfloat16 contract (``tests/test_bf16_parity.py``) on its own batch:
128 ISP-processed 64x64 images (seeded mosaics through the microscopy
``ParametrizedProcessing``, ``tests/test_bf16_parity.py:39-52``) and one
set of ResNet-18 weights (9 classes), carried to the port with
``convert.py``. The port's ``resnet_model(dtype=torch.bfloat16)`` is held

  * to JAX's bfloat16 model: logit drift (max over classes of |port -
    JAX| over the sample's logit spread in JAX) median < 2% and max < 10%,
    argmax agreement >= 99%;
  * to the port's float32 model under the same contract (JAX's own
    bfloat16 against float32);
  * stage by stage (``return_features=True``) to JAX's bfloat16 stages,
    so that a rounding point that differs shows where it is.

Measured on the CPU: the port's bfloat16 logits drift 0.025% median and
0.31% max from JAX's bfloat16 (0.34% / 0.74% from the port's float32,
which JAX's bfloat16 also shows against its float32), argmax agreement
100%; the stages are bitwise on 97.0-99.95% of their elements, at most
0.67% of the stage's largest magnitude apart (one bfloat16 ulp of it).
The bfloat16 steps, U-Net++ and the adversarial step are in
``test_torch_bf16_steps.py`` and ``test_torch_bf16_seg.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.data.datasets import MICROSCOPY_CAMERA_PARAMS
from raw2logit_tpu.isp import ParametrizedProcessing
from raw2logit_tpu.models import resnet_model as jax_resnet_model

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.models import resnet_model
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401
from test_torch_stem_bf16_resnet import assert_logit_contract

N_CLASSES, BATCH, SIZE = 9, 128, 64
# each stage against JAX's: bitwise share, and the largest difference as a
# share of the stage's largest magnitude (one bfloat16 ulp is 2^-7 of a
# value's binade, at most 0.78% of it)
STAGE_BITWISE, STAGE_MAX = 0.95, 2 ** -7


@pytest.fixture(scope="module")
def parity():
    """JAX's bfloat16 logits and stages on the JAX test's batch, the
    port's bfloat16 and float32 logits and bfloat16 stages on the same
    weights (NCHW numpy)."""
    rng = np.random.default_rng(0)
    raw = jnp.asarray(rng.uniform(size=(BATCH, SIZE, SIZE)), jnp.float32)
    proc = ParametrizedProcessing(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                                  image_size=SIZE)
    pvars = proc.init(jax.random.key(0), raw)
    rgb, _ = proc.apply(pvars, raw, train=False)
    cvars = jax_resnet_model("resnet18", fc_out_features=N_CLASSES).init(
        jax.random.key(1), rgb[:1], train=False)
    net = jax_resnet_model("resnet18", fc_out_features=N_CLASSES,
                           dtype=jnp.bfloat16)
    logits, stages = jax.jit(lambda v, x: (
        net.apply(v, x, train=False),
        net.apply(v, x, train=False, return_features=True)))(cvars, rgb)
    out = {"jax": np.asarray(logits),
           "jax_stages": [np.transpose(np.asarray(s.astype(jnp.float32)),
                                       (0, 3, 1, 2)) for s in stages]}
    x = torch.tensor(np.transpose(np.asarray(rgb), (0, 3, 1, 2)))
    sd = convert.resnet_state_dict(jax.device_get(cvars))
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = resnet_model("resnet18", fc_out_features=N_CLASSES,
                             dtype=dtype, device="cpu")
        model.load_state_dict(sd)
        with torch.no_grad():
            out[name] = model.eval()(x)
            if dtype == torch.bfloat16:
                out["stages"] = model(x, return_features=True)
    return out


def test_bf16_logits_are_float32(parity):
    assert parity["bf16"].dtype == torch.float32  # the fc head


def test_bf16_logits_match_jax_bf16(parity):
    assert_logit_contract(parity["bf16"].numpy(), parity["jax"])


def test_bf16_logits_within_contract_of_float32(parity):
    assert_logit_contract(parity["bf16"].numpy(), parity["f32"].numpy())


@pytest.mark.parametrize("stage", range(6))
def test_bf16_stages_match_jax(parity, stage):
    """Stage 0 is the float32 input; 1 the stem (1/2), 2-5 the stages'
    outputs, all bfloat16 in both."""
    want = parity["jax_stages"][stage]
    got = parity["stages"][stage]
    assert got.dtype == (torch.float32 if stage == 0 else torch.bfloat16)
    got = got.float().numpy()
    assert np.mean(got == want) >= STAGE_BITWISE
    assert np.abs(got - want).max() <= STAGE_MAX * np.abs(want).max()
