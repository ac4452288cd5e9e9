"""The port's TemporalNet backward against the JAX package's, on the CPU:
the plain version of K3 against ``jax.vjp`` of ``temporal_net._reference``
and against ``_pallas_bwd`` in interpret mode; the autograd Function
against autograd through the plain forward. The CUDA kernel is held to the
plain version in test_torch_port_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dist_tpu.ops import temporal_net as jtn
from dist_tpu_torch.models.dist.dist_net import DiSTConfig, TemporalNet
from dist_tpu_torch.ops import temporal_net as port

B, T, H, W, C = 2, 4, 6, 6, 16
K = 3
NAMES = ("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    g = rng.standard_normal((B, T, H, W, C)).astype(np.float32)
    r = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    params = (1.0 + r(C), r(C), r(K, 1, 1, C, C), r(C), r(1, 3, 3, C, C),
              r(C))
    return x, g, params


def _torch(arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("which", ["vjp", "pallas_interpret"])
def test_plain_bwd_matches_jax(case, which):
    """All 7 grads, fp32, at the tolerances of
    tests/test_fused_temporal_net.py (dx atol 2e-4; weights atol 5e-3,
    rtol 5e-4): the same fp32 math, summed in another order."""
    x, g, params = case
    got = port.temporal_net_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                      *_torch(params))
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    jp = [jnp.asarray(p) for p in params]
    if which == "vjp":
        import jax
        _, vjp = jax.vjp(jtn._reference, jx, *jp)
        want = vjp(jg)
    else:
        want = jtn._pallas_bwd(jx, jg, *jp, interpret=True)
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        if name == "dx":
            np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=0,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a.numpy(), b, atol=5e-3, rtol=5e-4,
                                       err_msg=name)


def test_function_grads_equal_autograd_through_plain(case):
    """The Function's backward (K3's plain version on the CPU) against
    autograd through ``temporal_net_plain``: the same fp32 math, summed in
    another order (atol 1e-5 relative to each gradient's largest value)."""
    x, g, params = case
    grads = []
    for fn in (port.temporal_net, port.temporal_net_plain):
        xt = torch.from_numpy(x).requires_grad_()
        pt = [p.requires_grad_() for p in _torch(params)]
        fn(xt, *pt).backward(torch.from_numpy(g))
        grads.append([xt.grad] + [p.grad for p in pt])
    for name, a, b in zip(NAMES, *grads):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=name)


def test_bf16_keeps_dx_dtype_and_params_dtypes(case):
    """bf16 x: fp32 inside, dx in bf16, the weight grads in the parameters'
    fp32; dx within one bf16 step (2^-8 relative, atol 1e-2 at |dx| ~ 1)
    of the fp32 computation on the same rounded inputs."""
    x, g, params = case
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gb = torch.from_numpy(g).to(torch.bfloat16)
    got = port.fused_temporal_net_bwd(xb, gb, *_torch(params))
    assert got[0].dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in got[1:])
    want = port.temporal_net_bwd_plain(xb.float(), gb.float(), *_torch(params))
    torch.testing.assert_close(got[0].float(), want[0], atol=1e-2, rtol=2 ** -8)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing(case):
    x, g, params = case
    before = port.fused_temporal_net_bwd.launches
    got = port.fused_temporal_net_bwd(torch.from_numpy(x), torch.from_numpy(g),
                                      *_torch(params))
    want = port.temporal_net_bwd_plain(torch.from_numpy(x), torch.from_numpy(g),
                                       *_torch(params))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert port.fused_temporal_net_bwd.launches == before


def test_fused_module_grads_reach_the_torch_conv_weights(case):
    """The fused TemporalNet's gradients come back in the raw layouts and
    land, through the permute views, on the torch-layout conv weights: the
    same as the unfused module's (autograd through torch convs)."""
    x, g, (lns, lnb, w1, b1, w2, b2) = case
    cfg = DiSTConfig(selected_layers=(0,), temporal_dim=C, num_frames=T)
    grads = []
    for fused in (True, False):
        mod = TemporalNet(cfg, fused=fused)
        mod.load_state_dict({
            "ln.weight": torch.from_numpy(lns), "ln.bias": torch.from_numpy(lnb),
            "temporal_net.c_fc1.weight": torch.from_numpy(w1).permute(
                4, 3, 0, 1, 2),
            "temporal_net.c_fc1.bias": torch.from_numpy(b1),
            "temporal_net.c_fc2.weight": torch.from_numpy(w2).permute(
                4, 3, 0, 1, 2),
            "temporal_net.c_fc2.bias": torch.from_numpy(b2)})
        xt = torch.from_numpy(x).requires_grad_()
        mod(xt).backward(torch.from_numpy(g))
        grads.append({"x": xt.grad, **{k: p.grad for k, p in
                                       mod.named_parameters()}})
        assert mod._packed is None              # nothing cached with grad on
    for k, b in grads[1].items():
        torch.testing.assert_close(grads[0][k], b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()), msg=k)


@pytest.mark.parametrize("shape", [(B, T, H, W, C + 1), (B, T, H, W + 1, C)])
def test_misshaped_cotangent_raises(case, shape):
    x, _, params = case
    with pytest.raises(ValueError, match="cotangent"):
        port.fused_temporal_net_bwd(torch.from_numpy(x), torch.zeros(shape),
                                    *_torch(params))
