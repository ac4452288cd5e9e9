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
# lengths at the edges of the card's routes (the whole-row instances pad L
# to 80, 208 and 272; longer rows stream), at tiny width
EDGE_SHAPES = [(1, l, 2, 16) for l in (80, 81, 208, 209, 273)]


def _qkv(b, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, 3 * h * hd)).astype(np.float32)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
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


@pytest.mark.parametrize("l,hd,dtype,route", [
    (1, 64, torch.bfloat16, "whole_row"),
    (77, 64, torch.bfloat16, "whole_row"),
    (80, 64, torch.bfloat16, "whole_row"),
    (81, 32, torch.bfloat16, "whole_row"),
    (197, 16, torch.bfloat16, "whole_row"),
    (272, 64, torch.bfloat16, "whole_row"),
    (273, 64, torch.bfloat16, "streaming"),
    (1000, 16, torch.bfloat16, "streaming"),
    (197, 128, torch.bfloat16, "streaming"),
    (1, 128, torch.bfloat16, "streaming"),
    (197, 64, torch.float32, "fp32"),
    (77, 64, torch.float32, "fp32"),
    (273, 128, torch.float32, "fp32"),
])
def test_attention_route_at_the_edges(l, hd, dtype, route):
    assert port.attention_route(l, hd, dtype) == route
    assert route in port.ROUTES
    assert (route == "whole_row") == (
        dtype == torch.bfloat16 and hd <= 64 and l <= port.WHOLE_ROW_LENS[-1])


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

