"""The port's TemporalNet block against the JAX package's: the plain
version of the kernel and the unfused module against
``temporal_net._reference``, the Pallas forward in interpret mode and the
flax ``TemporalNet``, on the CPU. The CUDA kernel is held to the plain
version in test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu.models.dist.dist_net import TemporalNet as JaxTemporalNet
from dist_tpu.ops import temporal_net as jtn
from dist_tpu_torch.models.dist.dist_net import DiSTConfig, TemporalNet
from dist_tpu_torch.ops import temporal_net as port

B, T, H, W, C = 2, 4, 5, 6, 8
K = 3


def _params(c, f, k, seed):
    """Raw JAX-layout params, non-trivial LN so its terms are exercised."""
    rng = np.random.default_rng(seed)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    return (1.0 + r(c), r(c), r(k, 1, 1, c, f), r(f), r(1, 3, 3, f, c), r(c))


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    return x, _params(C, C, K, seed=1)


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_plain_matches_jax_reference_and_pallas(case):
    x, params = case
    got = port.temporal_net_plain(torch.from_numpy(x), *_torch(params)).numpy()
    jparams = [jnp.asarray(p) for p in params]
    ref = np.asarray(jtn._reference(jnp.asarray(x), *jparams))
    pal = np.asarray(jtn._pallas_fwd(jnp.asarray(x), *jparams, interpret=True))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pal, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fused", [False, True])
def test_module_matches_flax_module(case, fused):
    """The port's TemporalNet (torch-layout params) against the flax module
    with the same weights, both with and without the fused path."""
    x, (lns, lnb, w1, b1, w2, b2) = case
    cfg = DiSTConfig(selected_layers=(0,), temporal_dim=C, num_frames=T)
    mod = TemporalNet(cfg, fused=fused)
    with torch.no_grad():
        mod.ln.weight.copy_(torch.from_numpy(lns))
        mod.ln.bias.copy_(torch.from_numpy(lnb))
        fc1, fc2 = mod.temporal_net["c_fc1"], mod.temporal_net["c_fc2"]
        fc1.weight.copy_(torch.from_numpy(w1).permute(4, 3, 0, 1, 2))
        fc1.bias.copy_(torch.from_numpy(b1))
        fc2.weight.copy_(torch.from_numpy(w2).permute(4, 3, 0, 1, 2))
        fc2.bias.copy_(torch.from_numpy(b2))
        got = mod(torch.from_numpy(x)).numpy()
    jcfg = JaxDiSTConfig(selected_layers=(0,), temporal_dim=C, num_frames=T)
    variables = {"params": {"ln": {"scale": lns, "bias": lnb},
                            "c_fc1": {"kernel": w1, "bias": b1},
                            "c_fc2": {"kernel": w2, "bias": b2}}}
    want = np.asarray(JaxTemporalNet(jcfg).apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plain_bf16_matches_jax_reference(case):
    x, params = case
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = port.temporal_net_plain(xb, *_torch(params)).float().numpy()
    ref = np.asarray(jtn._reference(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16),
        *[jnp.asarray(p) for p in params]), np.float32)
    # fp32 inside on both sides; only the final rounding to bf16 (relative
    # step 2^-8) can land on different sides of a tie
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=1e-2)


def test_module_packs_kernel_weights_once_per_parameter_version(case):
    """The fused module packs w1 to (k*C, F) and w2 to (9*F, C), tap-major,
    keeps the pack while the parameters stay as they are, and packs again
    after an in-place change or a move to another type."""
    _, (lns, lnb, w1, b1, w2, b2) = case
    cfg = DiSTConfig(selected_layers=(0,), temporal_dim=C, num_frames=T)
    mod = TemporalNet(cfg, fused=True)
    first = mod._packed_weights(mod._raw_params())
    assert mod._packed_weights(mod._raw_params()) is first
    fc1, fc2 = mod.temporal_net["c_fc1"], mod.temporal_net["c_fc2"]
    with torch.no_grad():
        fc1.weight.copy_(torch.from_numpy(w1).permute(4, 3, 0, 1, 2))
        fc2.weight.copy_(torch.from_numpy(w2).permute(4, 3, 0, 1, 2))
    packed = mod._packed_weights(mod._raw_params())
    assert packed is not first
    w1p, w2p = packed[2].numpy(), packed[4].numpy()
    assert w1p.shape == (K * C, C) and w2p.shape == (9 * C, C)
    for d in range(K):
        np.testing.assert_array_equal(w1p[d * C:(d + 1) * C], w1[d, 0, 0])
    for tap in range(9):
        np.testing.assert_array_equal(w2p[tap * C:(tap + 1) * C],
                                      w2[0, tap // 3, tap % 3])
    mod.double()
    assert mod._packed is None
    assert mod._packed_weights(mod._raw_params())[4].dtype == torch.float32


def test_wrapper_on_cpu_takes_plain_and_counts_nothing(case):
    x, params = case
    before = port.fused_temporal_net.launches
    got = port.fused_temporal_net(torch.from_numpy(x), *_torch(params))
    want = port.temporal_net_plain(torch.from_numpy(x), *_torch(params))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert port.fused_temporal_net.launches == before


@pytest.mark.parametrize("which,shape", [
    ("w1", (K, 1, 1, C + 1, C)),       # w1.shape[-2] != C
    ("w1", (K, 3, 1, C, C)),           # not a (k, 1, 1) kernel
    ("w2", (1, 3, 1, C, C)),           # w2.shape[:3] != (1, 3, 3)
    ("w2", (1, 3, 3, C, C + 1)),       # w2.shape[-1] != C
    ("w2", (1, 3, 3, C + 2, C)),       # w2 in-channels != w1 out-channels
])
def test_misshaped_kernels_raise(case, which, shape):
    x, params = case
    params = list(_torch(params))
    params[2 if which == "w1" else 4] = torch.zeros(shape)
    with pytest.raises(ValueError):
        port.fused_temporal_net(torch.from_numpy(x), *params)

