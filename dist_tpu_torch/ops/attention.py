"""Fused multi-head attention from the fused (B, L, 3D) qkv projection.

Port of ``dist_tpu/ops/attention.py``. Every self-attention in both CLIP
towers calls :func:`fused_attention_qkv` on the output of the fused qkv
projection, in its native layout, so no head transposes happen around it:

    per head h:  S = (Q_h hd^-1/2) K_h^T   (fp32; Q scaled in fp32 and
                                           never rounded, as the TPU
                                           kernel scales it)
                 P = softmax(S)            (fp32; causal mask optional),
                                           rounded to the input dtype
                 O_h = P V_h               (fp32 accumulation)

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/attention.cu``, or raises. On a CPU tensor it runs
:func:`attention_qkv_plain`, the plain PyTorch version that mirrors the
JAX package's ``_reference_attention_qkv``. There is no backward kernel
yet, so the CUDA path refuses inputs that need a gradient.

:func:`attention_qkv_rows` is the port of the microbenchmark's
multi-row variant (``tools/microbench.py::kernel_nb``): the same function
without the causal mask, with ``nb`` batch rows per block of the kernel;
its plain version is :func:`attention_qkv_rows_plain`.

On the card both take one of three routes, fixed by (L, head dim, dtype)
and named by :func:`attention_route`: ``whole_row`` (bf16, head dim 16,
32 or 64, L <= 272: a warp keeps its whole row of scores in registers),
``streaming`` (every other bf16 case: keys in chunks of 64, two passes)
and ``fp32`` (CUDA cores).
"""

import ctypes

import torch

from dist_tpu_torch.ops import _build

# The JAX package runs its reference math above this length
# (dist_tpu/ops/attention.py:115); the port's callers do the same.
MAX_FUSED_LEN = 1024

_SIGNATURES = {
    "dtt_attention_qkv": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p],
    "dtt_attention_qkv_rows": [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_float, ctypes.c_int,
                               ctypes.c_int, ctypes.c_void_p],
    "dtt_attention_rows_smem_bytes": [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int],
    "dtt_attention_blocks_per_sm": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int],
    "dtt_attention_error_string": [ctypes.c_int],
}
_HEAD_DIMS = (16, 32, 64, 128)
# the kernels' routes, numbered as in csrc/attention.cu
ROUTES = ("whole_row", "streaming", "fp32")
# the padded lengths of the whole-row kernel's instances; the last is the
# longest row whose scores a warp holds in registers
WHOLE_ROW_LENS = (80, 208, 272)
_WHOLE_ROW_HEAD_DIMS = (16, 32, 64)


def attention_route(l, head_dim, dtype):
    """The kernel route for sequence length ``l``, head dim and dtype, by
    the rule ``csrc/attention.cu`` applies: ``"fp32"`` for float32,
    ``"whole_row"`` for bf16 at head dim 16/32/64 and ``l <= 272``, else
    ``"streaming"``."""
    if dtype != torch.bfloat16:
        return "fp32"
    if head_dim in _WHOLE_ROW_HEAD_DIMS and l <= WHOLE_ROW_LENS[-1]:
        return "whole_row"
    return "streaming"


def attention_qkv_plain(qkv, num_heads, causal=False):
    """Plain PyTorch multi-head attention on the fused (B, L, 3D)
    projection; the CPU path and the kernel's yardstick."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    q, k, v = qkv.split(d, dim=-1)
    q = q.reshape(b, l, num_heads, hd)
    k = k.reshape(b, l, num_heads, hd)
    v = v.reshape(b, l, num_heads, hd)
    logits = torch.einsum("blhd,bmhd->bhlm", q.float() * hd ** -0.5,
                          k.float())
    if causal:
        mask = torch.full((l, l), float("-inf"), device=qkv.device).triu(1)
        logits = logits + mask
    p = torch.softmax(logits, dim=-1).to(qkv.dtype)
    o = torch.einsum("bhlm,bmhd->blhd", p.float(), v.float()).to(qkv.dtype)
    return o.reshape(b, l, d)


def _check(qkv, num_heads):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, L, 3D), got {tuple(qkv.shape)}")
    d = qkv.shape[-1] // 3
    if num_heads <= 0 or d % num_heads:
        raise ValueError(f"D={d} is not divisible by num_heads={num_heads}")


def _check_cuda(qkv, num_heads):
    """The kernels' refusals for a tensor that is not on the CPU; returns
    (B, L, D, head dim)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if qkv.dtype == torch.bfloat16 and qkv.data_ptr() % 16:
        raise ValueError("bf16 qkv must start on a 16-byte boundary")
    if qkv.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the attention kernel has no backward yet; run "
                           "the frozen towers under torch.no_grad()")
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    if hd not in _HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {_HEAD_DIMS}")
    if num_heads > 65535:
        raise ValueError(f"grid too large: heads={num_heads}")
    return b, l, d, hd


def _launch(fn, qkv, route, *args):
    """Allocate the output and run the C entry ``fn`` of the attention
    library on ``route`` on qkv's stream; raises on a CUDA error."""
    lib = _build.load("attention", _SIGNATURES)
    b, l, d3 = qkv.shape
    out = torch.empty((b, l, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn)(
            qkv.data_ptr(), out.data_ptr(), b, l, d3 // 3, *args,
            int(qkv.dtype == torch.bfloat16), ROUTES.index(route), stream)
    _build.check(lib, "dtt_attention_error_string", err, "attention kernel")
    return out


def fused_attention_qkv(qkv, num_heads, causal=False, _route=None):
    """O (B, L, D) = multi-head softmax attention of the fused projection
    ``qkv`` (B, L, 3D). CUDA tensor: the hand-written kernel on the route
    :func:`attention_route` names; CPU tensor: :func:`attention_qkv_plain`.

    ``_route="streaming"`` times the streaming kernel where the rule says
    ``whole_row``; no caller on a main path passes it, and the kernel
    refuses any other route against the rule."""
    _check(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, causal)
    b, l, _, hd = _check_cuda(qkv, num_heads)
    if b > 65535:
        raise ValueError(f"grid too large: B={b}")
    route = _route or attention_route(l, hd, qkv.dtype)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    out = _launch("dtt_attention_qkv", qkv, route, num_heads, int(causal),
                  hd ** -0.5)
    fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0


def _check_rows(qkv, num_heads, nb):
    _check(qkv, num_heads)
    if int(nb) != nb or nb < 1:
        raise ValueError(f"nb must be a positive integer, got {nb}")
    if qkv.shape[0] % nb:
        # the TPU kernel's grid (B // nb,) would leave the last B % nb rows
        # unwritten
        raise ValueError(f"B={qkv.shape[0]} is not a multiple of nb={nb}")


def attention_qkv_rows_plain(qkv, num_heads, nb):
    """Plain version of :func:`attention_qkv_rows`: the same refusals, then
    :func:`attention_qkv_plain` without the causal mask (``nb`` only sets
    how the kernel splits the batch)."""
    _check_rows(qkv, num_heads, nb)
    return attention_qkv_plain(qkv, num_heads, causal=False)


def rows_smem_bytes(l, head_dim, dtype):
    """Dynamic shared memory per block of the multi-row kernel at sequence
    length ``l`` on its route (whole_row: the Q tile and one row's whole
    K_h and V_h)."""
    lib = _build.load("attention", _SIGNATURES)
    return lib.dtt_attention_rows_smem_bytes(l, head_dim,
                                             int(dtype == torch.bfloat16))


def blocks_per_sm(l, head_dim, dtype, rows=False, causal=False):
    """Blocks of K1 (or K4, ``rows=True``) that fit on one SM on the route
    :func:`attention_route` names, from CUDA's occupancy calculator."""
    lib = _build.load("attention", _SIGNATURES)
    n = lib.dtt_attention_blocks_per_sm(l, head_dim,
                                        int(dtype == torch.bfloat16),
                                        int(rows), int(causal))
    if n < 0:
        raise RuntimeError(f"no attention kernel at L={l}, head dim "
                           f"{head_dim}, {dtype}")
    return n


def attention_qkv_rows(qkv, num_heads, nb):
    """O (B, L, D): :func:`fused_attention_qkv`'s function without the
    causal mask, with ``nb`` batch rows per block of the kernel (B % nb ==
    0). CUDA tensor: the hand-written kernel; CPU tensor:
    :func:`attention_qkv_rows_plain`."""
    _check_rows(qkv, num_heads, nb)
    if qkv.device.type == "cpu":
        return attention_qkv_rows_plain(qkv, num_heads, nb)
    b, l, _, hd = _check_cuda(qkv, num_heads)
    if b // nb > 65535:
        raise ValueError(f"grid too large: B/nb={b // nb}")
    out = _launch("dtt_attention_qkv_rows", qkv,
                  attention_route(l, hd, qkv.dtype), num_heads, int(nb),
                  hd ** -0.5)
    attention_qkv_rows.launches += 1
    return out


attention_qkv_rows.launches = 0
