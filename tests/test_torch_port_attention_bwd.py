"""The backward of the port's fused attention against the JAX package's,
on the CPU.

The JAX package's ``fused_attention_qkv`` is a ``custom_vjp`` whose
backward is the vjp of ``_reference_attention_qkv``, recomputed from qkv.
The same numpy qkv and cotangent, made from a seed, go through
``jax.vjp`` of that reference (jitted) and through the port's
``attention_qkv_bwd_plain`` (the CPU path of the backward and the CUDA
kernel's yardstick) and ``torch.autograd.grad`` of ``fused_attention_qkv``
on the CPU.

Tolerances, each third (dQ, dK, dV) against the largest entry of the JAX
third:
- fp32: 1e-5. Both sides compute in fp32 and differ only in the order of
  the sums (readings up to 8.7e-7).
- bf16: 2^-6. Both round P, dP and the outputs to bf16 at the same
  places, but at head dim 32 the JAX reference rounds ``q * scale`` to
  bf16 (the scale is not a power of two there) where the port scales in
  fp32, as the TPU kernel does, and the bf16 outputs of sums taken in
  another order may land one step apart (readings up to 7.4e-3 at head
  dim 32, 1.6e-3 at 64, 0 at 16).
The control, the backward with the ``rowsum(P dP)`` term dropped
(``tools/attn_bwd.py::bwd_without_rowsum``), must break them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.ops.attention import _reference_attention_qkv
from dist_tpu_torch.ops import attention as att
from dist_tpu_torch.tools.attn_bwd import bwd_without_rowsum, thirds_err

TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}
# (L, head dim): every length and head dim of the kernel's checks here,
# at batch 2 and 2 heads
CASES = [(17, 16), (77, 32), (197, 64), (1, 64)]


def _inputs(l, hd, causal, heads=2, b=2):
    rng = np.random.default_rng(1000 * l + hd + causal)
    qkv = rng.standard_normal((b, l, 3 * heads * hd)).astype(np.float32)
    dout = rng.standard_normal((b, l, heads * hd)).astype(np.float32)
    return qkv, dout


@pytest.fixture(scope="module")
def jax_vjps():
    """{(dtype, causal): [the JAX vjp of each of CASES]}: one jitted call
    over the four cases for each (dtype, causal), so that XLA compiles
    four programs, not sixteen."""
    def vjps(causal, *args):
        return [jax.vjp(lambda x: _reference_attention_qkv(x, 2, causal),
                        t)[1](g)[0].astype(jnp.float32)
                for t, g in zip(args[0::2], args[1::2])]

    out = {}
    for dtype in ("float32", "bfloat16"):
        for causal in (False, True):
            args = [jnp.asarray(a).astype(dtype) for l, hd in CASES
                    for a in _inputs(l, hd, causal)]
            fn = jax.jit(vjps, static_argnums=0)
            out[dtype, causal] = [np.asarray(v) for v in fn(causal, *args)]
    return out


def _breaks(got, want, tol):
    """Whether ``got`` lies beyond ``tol`` of the largest |want| of dQ and
    dK (or 1, where both are 0: L = 1)."""
    d = want.shape[-1] // 3
    scale = max(float(want[..., :2 * d].abs().max()), 1.0)
    return float((got.float() - want).abs().max()) > tol * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l,hd", CASES)
def test_backward_matches_the_jax_vjp(jax_vjps, l, hd, causal, dtype):
    heads = 2
    qkv, dout = _inputs(l, hd, causal)
    want = jax_vjps[dtype, causal][CASES.index((l, hd))]
    tdt = getattr(torch, dtype)
    tq = torch.from_numpy(qkv).to(tdt)
    td = torch.from_numpy(dout).to(tdt)
    plain = att.attention_qkv_bwd_plain(tq, td, heads, causal)
    x = tq.clone().requires_grad_()
    (through,) = torch.autograd.grad(att.fused_attention_qkv(x, heads, causal),
                                     x, td)
    assert plain.dtype == through.dtype == tdt
    assert torch.equal(through, plain)      # the CPU backward is the plain one
    want = torch.from_numpy(want)
    errs = thirds_err(plain, want)
    assert max(errs) <= TOL[dtype], errs
    control = bwd_without_rowsum(tq, td, heads, causal)
    assert _breaks(control, want, TOL[dtype]), thirds_err(control, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_is_the_autograd_vjp_of_the_plain_forward(causal,
                                                                  dtype):
    """The spelled-out vjp against autograd through
    ``attention_qkv_plain``: the same roundings, sums in another order
    (fp32 within 1e-6 of the largest entry; bf16 within one bf16 step of
    it)."""
    qkv, dout = _inputs(197, 64, causal)
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_()
    td = torch.from_numpy(dout).to(tdt)
    (want,) = torch.autograd.grad(att.attention_qkv_plain(x, 2, causal), x, td)
    got = att.attention_qkv_bwd_plain(x.detach(), td, 2, causal)
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err


def test_fused_attention_keeps_no_graph_without_a_gradient():
    qkv, _ = _inputs(17, 16, False)
    x = torch.from_numpy(qkv).requires_grad_()
    with torch.no_grad():
        assert att.fused_attention_qkv(x, 2).grad_fn is None
    assert att.fused_attention_qkv(x.detach(), 2).grad_fn is None
    assert att.fused_attention_qkv(x, 2).grad_fn is not None


def test_backward_refuses_a_cotangent_of_another_shape():
    qkv, dout = _inputs(17, 16, False)
    with pytest.raises(ValueError, match="dout must be"):
        att.attention_qkv_bwd(torch.from_numpy(qkv),
                              torch.from_numpy(dout[:, :-1]), 2)


@pytest.mark.parametrize("l,hd,dtype,route", [
    (197, 64, torch.bfloat16, "whole_row"), (1, 16, torch.bfloat16, "whole_row"),
    (77, 32, torch.bfloat16, "whole_row"), (272, 64, torch.bfloat16, "whole_row"),
    (273, 64, torch.bfloat16, "streaming"), (577, 64, torch.bfloat16, "streaming"),
    (197, 128, torch.bfloat16, "streaming"), (197, 64, torch.float32, "fp32"),
    (77, 16, torch.float32, "fp32")])
def test_backward_route_rule(l, hd, dtype, route):
    """K1b's route by the rule of ``csrc/whole_row.cuh``: whole_row for
    bf16 at head dim 16/32/64 and L <= 272, streaming for other bf16,
    fp32 for float32; K1's rule, so a backward takes its forward's
    route."""
    assert att.attention_bwd_route(l, hd, dtype) == route
    assert att.attention_route(l, hd, dtype) == route
