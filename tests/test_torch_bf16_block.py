"""PyTorch port vs the JAX package: one residual block's bfloat16 VJP.

The whole bfloat16 step's gradients (``test_torch_bf16_grads.py``) are
too ill-conditioned to hold tightly. One residual block is well
conditioned: the port's ``BasicBlock(dtype=torch.bfloat16)`` against
flax's ``BasicBlock`` with ``nn.Conv`` and ``nn.BatchNorm`` in bfloat16
(train-mode BN, every scale 0.5-1.5 so that no branch is skipped, 8
random 32x32 inputs, a random cotangent), with and without the
downsample. JAX's VJP is compiled with ``xla_allow_excess_precision``
off, so that it rounds where flax's program says. Every parameter's
gradient and the input's gradient is held within BLOCK_RATIO of the
distance (relative L2) that the port's float32 block reads from JAX's
bfloat16 one: the BNs' bfloat16 output left in float32, or the convs'
weight gradients scaled by 1.03, fail it (both pass the whole step's
test).

Measured on the CPU: the leaves and the input's gradient 1.6e-8 to
2.4e-2 from JAX's (the BN biases' sums of cotangents the largest), 0.39
of the float32 block's distance at most.
"""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raw2logit_tpu.models.resnet import BasicBlock as JaxBasicBlock

from raw2logit_tpu_torch import convert
from raw2logit_tpu_torch.models.resnet import BasicBlock
from test_torch_bf16_grads import leaf_rel
from test_torch_stem_bf16 import one_torch_thread  # noqa: F401

# each leaf's distance to JAX's bfloat16 gradient at most BLOCK_RATIO of
# the port's float32 one (measured: 0.39 at most)
BLOCK_RATIO = 0.5


@pytest.mark.parametrize("cin,cout,stride", [(64, 64, 1), (64, 128, 2)])
def test_bf16_block_vjp_leaf_by_leaf(cin, cout, stride):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 32, 32, cin)).astype(np.float32)
    block = JaxBasicBlock(
        cout, strides=(stride, stride),
        conv=partial(fnn.Conv, use_bias=False, dtype=jnp.bfloat16,
                     padding="SAME"),
        norm=partial(fnn.BatchNorm, use_running_average=False, momentum=0.9,
                     epsilon=1e-5, dtype=jnp.bfloat16))
    xb = jnp.asarray(x, jnp.bfloat16)
    v = jax.device_get(block.init(jax.random.key(1), xb))
    params = jax.tree_util.tree_map(  # the zero-init scale too
        lambda a: (a if np.any(a)
                   else rng.uniform(0.5, 1.5, a.shape).astype(np.float32)),
        v["params"])
    n_out = 8 * (32 // stride) ** 2 * cout
    ct = rng.normal(size=n_out).astype(np.float32).reshape(
        8, 32 // stride, 32 // stride, cout)

    def f(p, xx):
        y = block.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                        mutable=["batch_stats"])[0]
        return jnp.sum(y.astype(jnp.float32) * ct)

    gp, gx = jax.device_get(jax.jit(jax.grad(f, argnums=(0, 1))).lower(
        params, xb).compile({"xla_allow_excess_precision": False})(
            params, xb))

    def named(variables):  # the block's leaves under the port's names
        return {n[len("layer1.0."):]: t for n, t in convert.resnet_state_dict(
            {k: {"layer1_0": t} for k, t in variables.items()}).items()}

    want = {**named({"params": gp}), "x": torch.tensor(
        np.asarray(gx, np.float32)).permute(0, 3, 1, 2)}
    got = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        m = BasicBlock(cin, cout, stride, device="cpu", dtype=dtype)
        m.load_state_dict(named({"params": params,
                                 "batch_stats": v["batch_stats"]}))
        xt = torch.tensor(x).permute(0, 3, 1, 2).to(dtype).requires_grad_()
        (m(xt).float() * torch.tensor(ct).permute(0, 3, 1, 2)).sum().backward()
        got[name] = leaf_rel({**{n: p.grad for n, p in m.named_parameters()},
                              "x": xt.grad.float()}, want)
    assert set(got["bf16"]) == set(want)
    far = {n: (d, got["f32"][n]) for n, d in got["bf16"].items()
           if not d <= BLOCK_RATIO * got["f32"][n]}
    assert not far, far
