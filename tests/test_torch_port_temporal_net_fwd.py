"""K2's bf16 route against the JAX package, on the CPU: the route rule, the
scratch layout the C side reads, and the route's rounding (a bf16-operand
emulation, kept here and not in the package) against
``temporal_net._reference`` in fp32, held to ``FWD_BF16_LIMITS`` with the
dropped-tap control outside them. The CUDA kernel is held to the plain
version in test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dist_tpu.ops import temporal_net as jtn
from dist_tpu_torch.ops import temporal_net as port
from dist_tpu_torch.tools import tnet_bwd, tnet_fwd


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _qgelu(x):
    return x * torch.sigmoid(1.702 * x)


def emulate_bf16_route(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2, rnd=_bf16):
    """What K2's bf16 route computes (csrc/temporal_net.cu, the k3 head
    note), in fp32 with ``rnd`` at each of its roundings: LN(x) in fp32
    rounded to bf16 (xl); w1 and w2 rounded to bf16; the temporal taps
    summed in fp32, g = qgelu(. + b1) rounded to bf16; the 3x3 taps of g
    summed in fp32; out = qgelu(x + . + b2) in fp32, rounded once."""
    k, c, f = w1_raw.shape[0], w1_raw.shape[-2], w1_raw.shape[-1]
    t, h, w = x.shape[1:4]
    pad = k // 2
    xf = x.float()
    xl = rnd(F.layer_norm(xf, (c,), ln_s, ln_b, port.EPS))
    w1 = rnd(w1_raw.reshape(k, c, f))
    w2 = rnd(w2_raw.reshape(3, 3, f, c))
    xlp = F.pad(xl, (0, 0, 0, 0, 0, 0, pad, pad))
    hb = sum(xlp[:, d:d + t] @ w1[d] for d in range(k))
    g = rnd(_qgelu(hb + b1))
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))
    acc = sum(gp[:, :, dy:dy + h, dx:dx + w] @ w2[dy, dx]
              for dy in range(3) for dx in range(3))
    return rnd(_qgelu(xf + acc + b2))


def _case(shape, f, k, seed):
    """x (rounded to bf16, as the card gets it) and the block's parameters
    at chip_smoke.py's scales, from numpy."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    r = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x = torch.from_numpy(r(*shape)).to(torch.bfloat16)
    params = (1.0 + r(c, sc=0.1), r(c, sc=0.1),
              r(k, 1, 1, c, f, sc=(k * c) ** -0.5), r(f, sc=0.1),
              r(1, 3, 3, f, c, sc=(9 * f) ** -0.5), r(c, sc=0.1))
    return x, [torch.from_numpy(p) for p in params]


def _reference(x, params):
    """``dist_tpu.ops.temporal_net._reference`` in fp32 on the same
    (bf16-rounded) x."""
    out = jtn._reference(jnp.asarray(x.float().numpy()),
                         *[jnp.asarray(p.numpy()) for p in params])
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("dtype,route", [(torch.float32, "fp32"),
                                         (torch.bfloat16, "bf16_mma")])
def test_fwd_route_follows_the_dtype(dtype, route):
    assert port.temporal_net_fwd_route(dtype) == route
    assert port.temporal_net_fwd_route(dtype) == port.temporal_net_bwd_route(
        dtype)


@pytest.mark.parametrize("n,c,f,k", [(100352, 96, 96, 3), (25088, 96, 96, 3),
                                     (6272, 96, 96, 3), (240, 8, 8, 3),
                                     (105, 40, 24, 5), (1176, 128, 128, 1)])
def test_fwd_scratch_arrays_start_on_16_bytes(n, c, f, k):
    """The bf16 route's scratch (csrc/temporal_net.cu, k3::FwdLayout, in
    this order: the k + 9 forward tiles, xl, g, all bf16): each array is
    read by 16-byte copies, so each starts on a 16-byte boundary; the total
    is what the wrapper allocates. The fp32 route's scratch is its fp32
    g."""
    p = 32 * -(-max(c, f) // 32)
    offset = 0
    for size in ((k + 9) * p * p, n * c, n * f):
        assert (offset * 4) % 16 == 0
        offset += size // 2
    assert port.fwd_scratch_floats(n, c, f, k, torch.bfloat16) == offset
    assert port.fwd_scratch_floats(n, c, f, k) == n * f


# the card tests' shapes, the small ones (x's shape, F, k)
EMULATED = [((2, 4, 5, 6, 8), 8, 3), ((1, 5, 3, 7, 40), 24, 5),
            ((3, 2, 14, 14, 128), 128, 1), ((1, 4, 14, 14, 96), 96, 3)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("shape,f,k", EMULATED)
def test_bf16_route_rounding_within_limits_of_the_jax_reference(shape, f, k,
                                                                seed):
    """The route's rounding, emulated in PyTorch on the CPU, against the
    JAX package's fp32 ``_reference``: within ``FWD_BF16_LIMITS`` (set from
    the kernel's readings on the card); the control (the reference with
    w2's (0, 0) tap zeroed) breaks them."""
    x, params = _case(shape, f, k, seed)
    got = emulate_bf16_route(x, *params)
    assert got.shape == x.shape
    reading = tnet_fwd.errors(got, _reference(x, params))
    assert not tnet_bwd.breaches(reading, tnet_fwd.FWD_BF16_LIMITS), reading
    control = tnet_fwd.errors(got, _reference(
        x, tnet_bwd.control_params(params)))
    assert tnet_bwd.breaches(control, tnet_fwd.FWD_BF16_LIMITS), control


def test_emulation_without_rounding_is_the_plain_version():
    """The emulation's structure, not its rounding, against the port's plain
    version: with every rounding off the two agree to fp32 summation order
    (atol 1e-5)."""
    x, params = _case((2, 4, 5, 6, 8), 8, 3, seed=2)
    got = emulate_bf16_route(x.float(), *params, rnd=lambda t: t)
    want = port.temporal_net_plain(x.float(), *params)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_bf16_on_cpu_takes_any_width():
    """The multiple-of-8 rule is the bf16 kernel's: a CPU tensor runs the
    plain version at any width, and counts nothing."""
    x, params = _case((1, 2, 3, 3, 12), 12, 3, seed=3)
    before = port.fused_temporal_net.launches
    got = port.fused_temporal_net(x, *params)
    torch.testing.assert_close(got, port.temporal_net_plain(x, *params),
                               rtol=0, atol=0)
    assert port.fused_temporal_net.launches == before
