"""The port's multi-row attention (``attention_qkv_rows``, K4) against the
JAX package's ``kernel_nb`` of ``tools/microbench.py``, run in Pallas's
interpret mode on the CPU at the microbenchmark's own shape, and against
``_reference_attention_qkv`` and ``_pallas_attention_qkv`` at tiny shapes.
The CUDA kernel is held to the plain version in test_torch_port_cuda.py
and ``chip_smoke.py``."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas

from dist_tpu.ops.attention import (
    _pallas_attention_qkv,
    _reference_attention_qkv,
)
from dist_tpu_torch.ops import attention as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = 12      # the microbenchmark's (64, 197, 3 * 12 * 64) bf16 input


def _bf16_tolerance(qkv, want):
    """P and O are rounded to bf16 on both sides: one flip of P moves O by
    at most 2^-8 max|V|; one step of O is at most 2^-7 of |O|."""
    d = qkv.shape[-1] // 3
    vmax = float(np.abs(qkv[..., 2 * d:]).max())
    return 2 ** -8 * vmax + 2 ** -7 * np.abs(want)


@pytest.fixture(scope="module")
def microbench_attn(monkeypatch_module):
    """{variant: (f, x)} as ``cmd_attn`` hands them to ``_timeit``, with
    ``pallas_call`` in interpret mode for as long as the module's tests
    run."""
    spec = importlib.util.spec_from_file_location(
        "_jax_microbench", os.path.join(REPO, "tools", "microbench.py"))
    mb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mb)
    seen = {}
    monkeypatch_module.setattr(
        mb, "_timeit", lambda name, f, x, ref=None: seen.update({name: (f, x)}))
    monkeypatch_module.setattr(
        pallas, "pallas_call",
        functools.partial(pallas.pallas_call, interpret=True))
    mb.cmd_attn([])
    return seen


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("nb", [2, 4, 8])
def test_plain_matches_kernel_nb(microbench_attn, nb):
    f, x = microbench_attn[f"attn_pallas_rows{nb}"]
    want = np.asarray(f(x), np.float32)
    qkv = np.array(x.astype(jnp.float32))
    assert qkv.shape == (64, 197, 3 * HEADS * 64)
    got = port.attention_qkv_rows_plain(
        torch.from_numpy(qkv).to(torch.bfloat16), HEADS, nb).float().numpy()
    assert got.shape == want.shape
    assert (np.abs(got - want) <= _bf16_tolerance(qkv, want)).all()


def _qkv(b, l, h, hd, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, 3 * h * hd)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [1, 2, 4])
def test_plain_matches_reference_and_pallas_tiny(nb, dtype):
    b, l, h, hd = 4, 17, 2, 16
    x = _qkv(b, l, h, hd, seed=nb)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    x = xt.float().numpy()            # the values both sides see
    got = port.attention_qkv_rows_plain(xt, h, nb).float().numpy()
    xj = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(_reference_attention_qkv(xj, h, False), np.float32)
    pal = np.asarray(_pallas_attention_qkv(xj, h, False, interpret=True),
                     np.float32)
    for want in (ref, pal):
        if dtype == "float32":
            # fp32 on both sides; only the summation order differs
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        else:
            assert (np.abs(got - want) <= _bf16_tolerance(x, want)).all()


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    x = torch.from_numpy(_qkv(4, 17, 2, 16, seed=3))
    before = port.attention_qkv_rows.launches
    for nb in (1, 2, 4):
        got = port.attention_qkv_rows(x, 2, nb)
        torch.testing.assert_close(got, port.attention_qkv_plain(x, 2),
                                   rtol=0, atol=0)
    assert port.attention_qkv_rows.launches == before


@pytest.mark.parametrize("fn", [port.attention_qkv_rows,
                                port.attention_qkv_rows_plain])
@pytest.mark.parametrize("shape,heads,nb", [
    ((6, 5, 12), 2, 4),        # B % nb != 0: rows would go unwritten
    ((6, 5, 12), 2, 0),        # nb < 1
    ((6, 5, 12), 2, -2),
    ((6, 5, 12), 2, 1.5),      # not an integer
    ((6, 5, 7), 1, 1),         # last dim not 3D
    ((6, 5), 1, 1),            # not (B, L, 3D)
    ((6, 5, 12), 3, 2),        # D = 4 not divisible by 3 heads
])
def test_refusals(fn, shape, heads, nb):
    with pytest.raises(ValueError):
        fn(torch.zeros(shape), heads, nb)


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA card is refused,
    never computed by the plain version."""
    x = torch.zeros((4, 5, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.attention_qkv_rows(x, 1, 2)
