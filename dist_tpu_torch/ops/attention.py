"""Fused multi-head attention from the fused (B, L, 3D) qkv projection,
and its backward.

Port of ``dist_tpu/ops/attention.py``. Every self-attention in both CLIP
towers calls :func:`fused_attention_qkv` on the output of the fused qkv
projection, in its native layout, so no head transposes happen around it:

    per head h:  S = (Q_h hd^-1/2) K_h^T   (fp32; Q scaled in fp32 and
                                           never rounded, as the TPU
                                           kernel scales it)
                 P = softmax(S)            (fp32; causal mask optional),
                                           rounded to the input dtype
                 O_h = P V_h               (fp32 accumulation)

The forward is the custom operator ``dist_tpu_torch::attention_qkv(qkv,
num_heads, causal)`` (``torch.library``), so that ``torch.export`` can
trace it and a saved program calls it by name. Its CUDA kernel launches
the hand-written kernel of ``csrc/attention.cu`` (K1), or raises; its CPU
kernel is :func:`attention_qkv_plain`, the plain PyTorch version that
mirrors the JAX package's ``_reference_attention_qkv``; its fake kernel
gives the (B, L, D) output's shape. Importing this module registers it.

The function is differentiable, as the JAX package's ``custom_vjp`` is:
its backward recomputes the attention from ``qkv`` and gives dQ, dK, dV
in the fused layout. On a CUDA tensor that is the hand-written kernel of
``csrc/attention_bwd.cu`` (K1b, :func:`attention_qkv_bwd`), or a raise;
on a CPU tensor :func:`attention_qkv_bwd_plain`, the vjp of
:func:`attention_qkv_plain` spelled out. So an unfrozen CLIP tower trains
through both kernels; a frozen one runs under ``no_grad`` and launches K1
alone.

:func:`attention_qkv_rows` is the port of the microbenchmark's
multi-row variant (``tools/microbench.py::kernel_nb``): the same function
without the causal mask, with ``nb`` batch rows per block of the kernel;
its plain version is :func:`attention_qkv_rows_plain`. It runs only in the
microbenchmark, so it stays a direct ``ctypes`` call and no operator.

On the card K1, K4 and K1b take one of three routes, fixed by (L, head
dim, dtype) by one rule (``csrc/whole_row.cuh``), named by
:func:`attention_route` and :func:`attention_bwd_route`: ``whole_row``
(bf16, head dim 16, 32 or 64, L <= 272: a warp keeps its whole row of
scores in registers), ``streaming`` (every other bf16 case: keys in
chunks of 64 through shared memory) and ``fp32`` (CUDA cores).
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
_BWD_SIGNATURES = {
    "dtt_attention_qkv_bwd": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                             + [ctypes.c_float] + [ctypes.c_int] * 3
                             + [ctypes.c_void_p],
    "dtt_attention_bwd_blocks_per_sm": [ctypes.c_int] * 6,
    "dtt_attention_bwd_smem_bytes": [ctypes.c_int] * 5,
    "dtt_attention_bwd_error_string": [ctypes.c_int],
}
_HEAD_DIMS = (16, 32, 64, 128)
# the kernels' routes, numbered as in csrc/whole_row.cuh
ROUTES = ("whole_row", "streaming", "fp32")
# the padded lengths of the whole-row kernel's instances; the last is the
# longest row whose scores a warp holds in registers
WHOLE_ROW_LENS = (80, 208, 272)
_WHOLE_ROW_HEAD_DIMS = (16, 32, 64)


def attention_route(l, head_dim, dtype):
    """K1's and K4's route for sequence length ``l``, head dim and dtype,
    by the rule of ``csrc/whole_row.cuh``: ``"fp32"`` for float32,
    ``"whole_row"`` for bf16 at head dim 16/32/64 and ``l <= 272``, else
    ``"streaming"``."""
    if dtype != torch.bfloat16:
        return "fp32"
    if head_dim in _WHOLE_ROW_HEAD_DIMS and l <= WHOLE_ROW_LENS[-1]:
        return "whole_row"
    return "streaming"


def attention_bwd_route(l, head_dim, dtype):
    """K1b's route: the same rule as K1's (:func:`attention_route`), so a
    backward takes the route its forward took."""
    return attention_route(l, head_dim, dtype)


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


def _cuda_forward(qkv, num_heads, causal, route=None):
    """K1 on a CUDA tensor on ``route`` (by default the rule's); counts
    the launch."""
    b, l, _, hd = _check_cuda(qkv, num_heads)
    if b > 65535:
        raise ValueError(f"grid too large: B={b}")
    route = route or attention_route(l, hd, qkv.dtype)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    out = _launch("dtt_attention_qkv", qkv, route, num_heads, int(causal),
                  hd ** -0.5)
    fused_attention_qkv.launches += 1
    return out


@torch.library.custom_op("dist_tpu_torch::attention_qkv", mutates_args=(),
                         device_types="cuda")
def attention_qkv_op(qkv: torch.Tensor, num_heads: int,
                     causal: bool) -> torch.Tensor:
    """The operator K1 is: its CUDA kernel (the hand-written one, or a
    raise); :func:`attention_qkv_plain` is its CPU kernel."""
    return _cuda_forward(qkv, num_heads, causal)


attention_qkv_op.register_kernel("cpu")(attention_qkv_plain)


@attention_qkv_op.register_fake
def _attention_qkv_fake(qkv, num_heads, causal):
    b, l, d3 = qkv.shape
    return qkv.new_empty(b, l, d3 // 3)


def _forward(qkv, num_heads, causal, route):
    if route is None or qkv.device.type == "cpu":
        return attention_qkv_op(qkv, num_heads, causal)
    return _cuda_forward(qkv, num_heads, causal, route)


class _AttentionQKV(torch.autograd.Function):
    """K1 forward, K1b backward (their plain versions on the CPU); the
    backward recomputes from ``qkv``, as the JAX package's vjp does."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal, route):
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.save_for_backward(qkv)
        return _forward(qkv, num_heads, causal, route)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return (attention_qkv_bwd(qkv, dout.contiguous(), ctx.num_heads,
                                  ctx.causal), None, None, None)


def fused_attention_qkv(qkv, num_heads, causal=False, _route=None):
    """O (B, L, D) = multi-head softmax attention of the fused projection
    ``qkv`` (B, L, 3D), through the operator ``attention_qkv``. CUDA
    tensor: the hand-written kernel on the route :func:`attention_route`
    names; CPU tensor: :func:`attention_qkv_plain`.
    Differentiable: where ``qkv`` needs a gradient, the backward is
    :func:`attention_qkv_bwd`. ``launches`` counts the forward kernel's
    launches (a recomputation under ``torch.utils.checkpoint`` too).

    ``_route="streaming"`` times the streaming kernel where the rule says
    ``whole_row`` (beside the operator, which takes no route); no caller
    on a main path passes it, and the kernel refuses any other route
    against the rule."""
    _check(qkv, num_heads)
    if qkv.requires_grad and torch.is_grad_enabled():
        return _AttentionQKV.apply(qkv, num_heads, causal, _route)
    return _forward(qkv, num_heads, causal, _route)


fused_attention_qkv.launches = 0


def attention_qkv_bwd_plain(qkv, dout, num_heads, causal=False):
    """dqkv (B, L, 3D): the vjp of :func:`attention_qkv_plain` at ``qkv``
    for the cotangent ``dout`` (B, L, D), spelled out with the roundings
    autograd gives it: P in fp32 and, rounded to the input type, as P V
    reads it; dP = dO V^T rounded to the input type; dS = P (dP -
    rowsum(P dP)) in fp32; dQ = s dS K, dK = dS^T (s Q), dV = P^T dO, each
    rounded to the input type. The CPU path of the backward and K1b's
    yardstick."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    hd = d // num_heads
    s = hd ** -0.5
    q, k, v = (t.reshape(b, l, num_heads, hd).float()
               for t in qkv.split(d, dim=-1))
    logits = torch.einsum("blhd,bmhd->bhlm", q * s, k)
    if causal:
        mask = torch.full((l, l), float("-inf"), device=qkv.device).triu(1)
        logits = logits + mask
    p = torch.softmax(logits, dim=-1)
    do = dout.reshape(b, l, num_heads, hd).float()
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(qkv.dtype).float(), do)
    dp = torch.einsum("blhd,bmhd->bhlm", do, v).to(qkv.dtype).float()
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhlm,bmhd->blhd", ds, k) * s
    dk = torch.einsum("bhlm,blhd->bmhd", ds, q * s)
    return torch.cat([t.reshape(b, l, d).to(qkv.dtype) for t in (dq, dk, dv)],
                     dim=-1)


def _check_bwd(qkv, dout, num_heads):
    """K1b's refusals beyond K1's: every tensor fp32 or bf16 alike,
    contiguous and 16-byte aligned, L at most :data:`MAX_FUSED_LEN`."""
    b, l, d, hd = _check_cuda(qkv, num_heads)
    if dout.device != qkv.device or dout.dtype != qkv.dtype:
        raise ValueError(f"dout must be a {qkv.dtype} tensor on {qkv.device}, "
                         f"got {dout.dtype} on {dout.device}")
    if not dout.is_contiguous():
        raise ValueError("dout must be contiguous")
    if qkv.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("qkv and dout must start on a 16-byte boundary")
    if l > MAX_FUSED_LEN:
        raise ValueError(f"the attention backward kernel takes L <= "
                         f"{MAX_FUSED_LEN}, got qkv {tuple(qkv.shape)}")
    if b > 65535:
        raise ValueError(f"grid too large: B={b}")
    return b, l, d, hd


def attention_qkv_bwd(qkv, dout, num_heads, causal=False, _route=None):
    """dqkv (B, L, 3D) = the backward of :func:`fused_attention_qkv` at
    ``qkv`` for the cotangent ``dout`` (B, L, D). CUDA tensors: the
    hand-written kernel of ``csrc/attention_bwd.cu`` (K1b, two passes,
    one launch of the wrapper) on the route :func:`attention_bwd_route`
    names, or a raise naming what it cannot take; CPU tensors:
    :func:`attention_qkv_bwd_plain`. ``launches`` counts the kernel's
    launches.

    ``_route="streaming"`` times the streaming kernel where the rule says
    ``whole_row``; no caller on a main path passes it, and the kernel
    refuses any other route against the rule."""
    _check(qkv, num_heads)
    if tuple(dout.shape) != tuple(qkv.shape[:2]) + (qkv.shape[-1] // 3,):
        raise ValueError(f"dout must be (B, L, D) = "
                         f"{tuple(qkv.shape[:2]) + (qkv.shape[-1] // 3,)}, "
                         f"got {tuple(dout.shape)}")
    if qkv.device.type == "cpu":
        return attention_qkv_bwd_plain(qkv, dout, num_heads, causal)
    b, l, d, hd = _check_bwd(qkv, dout, num_heads)
    route = _route or attention_bwd_route(l, hd, qkv.dtype)
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}")
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((3, b, num_heads, l), dtype=torch.float32,
                        device=qkv.device)
    bwd_launch(qkv, dout, dqkv, stats, num_heads, causal, route)
    attention_qkv_bwd.launches += 1
    return dqkv


attention_qkv_bwd.launches = 0

# K1b's passes for bwd_launch: pass dq (dQ and each query row's
# statistics into the scratch), pass dkv (dK and dV from them), or both
BWD_PASSES = {"dq": 1, "dkv": 2, "both": 3}


def bwd_launch(qkv, dout, dqkv, stats, num_heads, causal, route,
               passes="both"):
    """Run K1b's ``passes`` (:data:`BWD_PASSES`) on ``route`` on qkv's
    stream, into ``dqkv`` and the fp32 scratch ``stats`` (3, B, heads,
    L); pass dkv alone reads the statistics a pass dq left there. No
    checks beyond the kernel's own and no launch count:
    :func:`attention_qkv_bwd` is the entry, this is its launch (and
    ``tools/attn_bwd.py passes`` times one pass with it)."""
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    b, l, d3 = qkv.shape
    d = d3 // 3
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtt_attention_qkv_bwd(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(),
            b, l, d, num_heads, int(causal), (d // num_heads) ** -0.5,
            int(qkv.dtype == torch.bfloat16), ROUTES.index(route),
            BWD_PASSES[passes], stream)
    _build.check(lib, "dtt_attention_bwd_error_string", err,
                 "attention backward kernel")


def _bwd_instance_args(l, head_dim, dtype, route):
    route = route or attention_bwd_route(l, head_dim, dtype)
    return l, head_dim, int(dtype == torch.bfloat16), ROUTES.index(route)


def bwd_blocks_per_sm(head_dim, dtype, l=MAX_FUSED_LEN, route=None,
                      causal=False):
    """{"dq": blocks, "dkv": blocks}: the blocks of K1b's two passes that
    fit on one SM at length ``l`` on ``route`` (by default the rule's; at
    the default length the streaming or fp32 instance, which serve every
    length), from CUDA's occupancy calculator."""
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    args = _bwd_instance_args(l, head_dim, dtype, route)
    out = {}
    for i, name in enumerate(("dq", "dkv")):
        n = lib.dtt_attention_bwd_blocks_per_sm(*args, int(causal), i)
        if n < 0:
            raise RuntimeError(f"no attention backward kernel at L={l}, "
                               f"head dim {head_dim}, {dtype}, route "
                               f"{route}")
        out[name] = n
    return out


def bwd_smem_bytes(head_dim, dtype, l=MAX_FUSED_LEN, route=None):
    """{"dq": bytes, "dkv": bytes}: the dynamic shared memory of a block of
    each of K1b's passes at length ``l`` on ``route`` (as
    :func:`bwd_blocks_per_sm`)."""
    lib = _build.load("attention_bwd", _BWD_SIGNATURES)
    args = _bwd_instance_args(l, head_dim, dtype, route)
    return {name: lib.dtt_attention_bwd_smem_bytes(*args, i)
            for i, name in enumerate(("dq", "dkv"))}


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
