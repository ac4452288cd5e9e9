"""The port's attention (ops/attention.py) against the JAX package's:
its plain version against ``_reference_attention_qkv`` and the Pallas
kernel in interpret mode, on the CPU. The CUDA kernel is held to the
plain version in test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dist_tpu.ops.attention import (
    _pallas_attention_qkv,
    _reference_attention_qkv,
)
from dist_tpu_torch.ops import attention as port

SHAPES = [(3, 29, 4, 16), (2, 77, 2, 32)]   # (batch, length, heads, head dim)


def _qkv(b, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, 3 * h * hd)).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_reference_and_pallas(shape, causal):
    b, l, h, hd = shape
    x = _qkv(b, l, h, hd, seed=l + causal)
    got = port.attention_qkv_plain(torch.from_numpy(x), h, causal).numpy()
    ref = np.asarray(_reference_attention_qkv(jnp.asarray(x), h, causal))
    pal = np.asarray(_pallas_attention_qkv(jnp.asarray(x), h, causal,
                                           interpret=True))
    # fp32 on both sides; only the summation order differs
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pal, atol=1e-5, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bf16_matches_jax_reference(causal):
    b, l, h, hd = SHAPES[1]
    x = _qkv(b, l, h, hd, seed=5)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = port.attention_qkv_plain(xt, h, causal).float().numpy()
    ref = np.asarray(_reference_attention_qkv(
        jnp.asarray(xt.float().numpy(), jnp.bfloat16), h, causal),
        np.float32)
    # bf16 keeps 8 mantissa bits: P and O are rounded to bf16 (relative
    # step 2^-8) at points where the two frameworks may round differently
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    b, l, h, hd = SHAPES[0]
    x = torch.from_numpy(_qkv(b, l, h, hd, seed=1))
    before = port.fused_attention_qkv.launches
    for causal in (False, True):
        got = port.fused_attention_qkv(x, h, causal)
        torch.testing.assert_close(
            got, port.attention_qkv_plain(x, h, causal), rtol=0, atol=0)
    assert port.fused_attention_qkv.launches == before


@pytest.mark.parametrize("bad", [(2, 5, 7), (2, 5, 12, 1)])
def test_wrapper_rejects_bad_shapes(bad):
    with pytest.raises(ValueError):
        port.fused_attention_qkv(torch.zeros(bad), 5)

