"""PyTorch port vs the JAX package: the bfloat16 stem at 64x32.

The port's plain bfloat16 stem against JAX's ``stem_train(...,
jnp.bfloat16, interpret=True)``, its VJP and ``stem_eval`` at B = 2, 64x32,
the second shape of ``test_torch_stem_bf16.py``, whose helpers and bounds
this file shares (a file of its own to keep each file short: JAX's
interpret mode compiles each shape anew). Measured on the CPU: pooled
bitwise on 99.988% of the elements (one element one ulp apart), eval
99.994%; statistics within 1.5e-7 relative; gradients within 2e-6 of
scale.
"""

import numpy as np
import pytest

from test_torch_stem_bf16 import (  # noqa: F401 (one_torch_thread)
    STATS_REL, assert_bf16_close, assert_grads_close, jax_stem_bf16,
    one_torch_thread, port_stem_bf16, stem_inputs)


@pytest.fixture(scope="module")
def wide():
    inputs = stem_inputs((2, 64, 32), 1)
    jax_out = jax_stem_bf16(inputs)
    return jax_out, port_stem_bf16(inputs, jax_out["ct"])


@pytest.mark.parametrize("what", ["statistics", "pooled", "eval",
                                  "gradients"])
def test_wide_stem_matches_jax(wide, what):
    """At 64x32: statistics within 1e-5 relative, pooled and the eval
    stem's pooled 99% bitwise and within one ulp, gradients within 5e-5 of
    scale."""
    jax_out, port = wide
    if what == "statistics":
        for key in ("mean", "var"):
            err = (np.abs(port[key] - jax_out[key]).max()
                   / np.abs(jax_out[key]).max())
            assert err < STATS_REL, (key, err)
    elif what == "gradients":
        assert_grads_close(port["grads"], jax_out["grads"])
    else:
        assert_bf16_close(port[what], jax_out[what])
