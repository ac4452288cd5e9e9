"""Q's scaling in the port's attention follows the TPU kernel
(``dist_tpu/ops/attention.py::_attn_kernel``): Q is scaled in fp32 and
never rounded to the input type. Held on the CPU in bf16 against
``_pallas_attention_qkv`` in interpret mode, at head dims whose scale
hd^-1/2 is not a power of two (32, 128) and at 64, where it is and the
result keeps the bits of rounding the scaled Q. The CUDA kernels are held
to the plain version in test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dist_tpu.ops.attention import _pallas_attention_qkv
from dist_tpu_torch.ops import attention as port

B, L, HEADS = 4, 197, 4
# share of bf16 outputs that may differ from the TPU kernel's: P is rounded
# to bf16 on both sides from fp32 values summed in another order, which
# flips the last bit of a few (0.03-0.06 % here); rounding the scaled Q
# moves about half of them (53 %)
MAX_DIFFERING = 0.01


def _qkv(hd):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, 3 * HEADS * hd)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


def _pallas(x):
    out = _pallas_attention_qkv(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                                HEADS, interpret=True)
    return np.asarray(out, np.float32)


def _rounded_q(x):
    """The port's plain version before the repair: Q times the scale,
    rounded to bf16, then fp32 scores."""
    d = x.shape[-1] // 3
    hd = d // HEADS
    q, k, v = (t.reshape(B, L, HEADS, hd) for t in x.split(d, dim=-1))
    logits = torch.einsum("blhd,bmhd->bhlm", (q * hd ** -0.5).float(),
                          k.float())
    p = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bhlm,bmhd->blhd", p.float(), v.float()).to(x.dtype)
    return o.reshape(B, L, d)


def _differing(a, b):
    return float((np.asarray(a, np.float32) != b).mean())


@pytest.mark.parametrize("hd", [32, 128])
def test_plain_bf16_follows_the_tpu_kernel(hd):
    x = _qkv(hd)
    got = port.attention_qkv_plain(x, HEADS).float().numpy()
    assert _differing(got, _pallas(x)) < MAX_DIFFERING


@pytest.mark.parametrize("hd", [32, 128])
def test_rounding_the_scaled_q_is_seen(hd):
    """The control: the old formula breaks the limit above."""
    x = _qkv(hd)
    assert _differing(_rounded_q(x).float().numpy(), _pallas(x)) > 0.3


@pytest.mark.parametrize("hd", [16, 64])
def test_power_of_two_scale_keeps_the_bits(hd):
    """hd^-1/2 = 1/4 or 1/8: scaling in fp32 gives exactly the bits of
    rounding the scaled Q, so no served or trained model's output moves."""
    x = _qkv(hd)
    assert torch.equal(port.attention_qkv_plain(x, HEADS), _rounded_q(x))
