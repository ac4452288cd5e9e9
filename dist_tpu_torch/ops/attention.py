"""Fused multi-head attention from the fused (B, L, 3D) qkv projection.

Port of ``dist_tpu/ops/attention.py``. Every self-attention in both CLIP
towers calls :func:`fused_attention_qkv` on the output of the fused qkv
projection, in its native layout, so no head transposes happen around it:

    per head h:  S = (Q_h hd^-1/2) K_h^T   (fp32)
                 P = softmax(S)            (fp32; causal mask optional),
                                           rounded to the input dtype
                 O_h = P V_h               (fp32 accumulation)

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/attention.cu``, or raises. On a CPU tensor it runs
:func:`attention_qkv_plain`, the plain PyTorch version that mirrors the
JAX package's ``_reference_attention_qkv``. There is no backward kernel
yet, so the CUDA path refuses inputs that need a gradient.
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
                          ctypes.c_void_p],
    "dtt_attention_error_string": [ctypes.c_int],
}
_HEAD_DIMS = (16, 32, 64, 128)


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
    logits = torch.einsum("blhd,bmhd->bhlm", (q * hd ** -0.5).float(),
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


def fused_attention_qkv(qkv, num_heads, causal=False):
    """O (B, L, D) = multi-head softmax attention of the fused projection
    ``qkv`` (B, L, 3D). CUDA tensor: the hand-written kernel; CPU tensor:
    :func:`attention_qkv_plain`."""
    _check(qkv, num_heads)
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, causal)
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
    if b > 65535 or num_heads > 65535:
        raise ValueError(f"grid too large: B={b}, heads={num_heads}")
    lib = _build.load("attention", _SIGNATURES)
    out = torch.empty((b, l, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtt_attention_qkv(
            qkv.data_ptr(), out.data_ptr(), b, l, d, num_heads, int(causal),
            hd ** -0.5, int(qkv.dtype == torch.bfloat16), stream)
    _build.check(lib, "dtt_attention_error_string", err, "attention kernel")
    fused_attention_qkv.launches += 1
    return out


fused_attention_qkv.launches = 0
