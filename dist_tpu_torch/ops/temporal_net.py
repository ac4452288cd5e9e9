"""Fused DiST TemporalNet block, forward.

Port of ``dist_tpu/ops/temporal_net.py`` (forward only; the backward
kernel comes with the training slice). The ladder's temporal block

    out = qgelu(x + conv(1,3,3)(qgelu(conv(k,1,1)(LN(x)) + b1)) + b2)

runs on channels-last x (B, T, H, W, C) with LayerNorm eps 1e-5, fp32
inside and the output in x's dtype. The signature and weight layouts are
the JAX package's: raw kernels ``w1 (k,1,1,C,F)`` and ``w2 (1,3,3,F,C)``.

On a CUDA tensor the wrapper launches the hand-written kernel of
``csrc/temporal_net.cu`` (two launches through an fp32 scratch the
wrapper allocates; one call, one count), or raises. On a CPU tensor it
runs :func:`temporal_net_plain`, which mirrors ``_reference`` /
``_chain_fwd``: each conv tap is a shifted view of the zero-padded
activations times one (C, F) weight block.
"""

import ctypes

import torch
import torch.nn.functional as F

from dist_tpu_torch.ops import _build

EPS = 1e-5
MAX_CHANNELS = 128

_SIGNATURES = {
    "dtt_temporal_net_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p],
    "dtt_temporal_net_error_string": [ctypes.c_int],
}


def _qgelu(x):
    return x * torch.sigmoid(1.702 * x)


def check_shapes(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2):
    """Entry checks of the block; returns (k, C, F). Raises ValueError."""
    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got {tuple(x.shape)}")
    c = x.shape[-1]
    if w1_raw.dim() != 5 or tuple(w1_raw.shape[1:3]) != (1, 1) \
            or w1_raw.shape[-2] != c:
        raise ValueError(f"w1 must be (k, 1, 1, C={c}, F), got "
                         f"{tuple(w1_raw.shape)}")
    k, f = w1_raw.shape[0], w1_raw.shape[-1]
    if w2_raw.dim() != 5 or tuple(w2_raw.shape[:3]) != (1, 3, 3) \
            or w2_raw.shape[-2] != f or w2_raw.shape[-1] != c:
        raise ValueError(f"w2 must be (1, 3, 3, F={f}, C={c}), got "
                         f"{tuple(w2_raw.shape)}")
    for name, v, n in (("ln_scale", ln_s, c), ("ln_bias", ln_b, c),
                       ("b1", b1, f), ("b2", b2, c)):
        if tuple(v.shape) != (n,):
            raise ValueError(f"{name} must be ({n},), got {tuple(v.shape)}")
    return k, c, f


def temporal_net_plain(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2):
    """Plain PyTorch version of the block; the CPU path and the kernel's
    yardstick."""
    k, c, f = check_shapes(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2)
    t, h, w = x.shape[1:4]
    pad = k // 2
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + EPS)
    xl = xc * rstd * ln_s.float() + ln_b.float()
    w1 = w1_raw.float().reshape(k, c, f)
    xlp = F.pad(xl, (0, 0, 0, 0, 0, 0, pad, pad))       # zero frames outside T
    hb = xlp[:, 0:t] @ w1[0]
    for d in range(1, k):
        hb = hb + xlp[:, d:d + t] @ w1[d]
    g = _qgelu(hb + b1.float())
    w2 = w2_raw.float().reshape(3, 3, f, c)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))                    # zero pixels outside
    acc = gp[:, :, 0:h, 0:w] @ w2[0, 0]
    for tap in range(1, 9):
        dy, dx = divmod(tap, 3)
        acc = acc + gp[:, :, dy:dy + h, dx:dx + w] @ w2[dy, dx]
    return _qgelu(xf + acc + b2.float()).to(x.dtype)


def pack_weights(ln_scale, ln_bias, w1_raw, b1, w2_raw, b2):
    """The kernel's operands from the block's parameters: fp32 and
    contiguous, w1 as (k*C, F) and w2 as (9*F, C), tap-major rows. A caller
    that serves many requests packs once and passes ``packed=``."""
    k, c, f = w1_raw.shape[0], w1_raw.shape[-2], w1_raw.shape[-1]
    with torch.no_grad():
        return (ln_scale.float().contiguous(), ln_bias.float().contiguous(),
                w1_raw.float().reshape(k * c, f).contiguous(),
                b1.float().contiguous(),
                w2_raw.float().reshape(9 * f, c).contiguous(),
                b2.float().contiguous())


def fused_temporal_net(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2,
                       packed=None):
    """TemporalNet block on x (B, T, H, W, C). CUDA tensor: the
    hand-written kernel, on ``packed`` (:func:`pack_weights` of the same
    parameters) or on weights packed for this call; CPU tensor:
    :func:`temporal_net_plain`."""
    k, c, f = check_shapes(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    if x.device.type == "cpu":
        return temporal_net_plain(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    params = (ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    if any(p.device != x.device for p in params):
        raise ValueError("the block's parameters must be on x's device")
    if torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in params)):
        raise RuntimeError("the TemporalNet kernel has no backward yet; run "
                           "it under torch.no_grad()")
    if c > MAX_CHANNELS or f > MAX_CHANNELS:
        raise ValueError(f"C={c} and F={f} must be <= {MAX_CHANNELS}")
    b, t, h, w, _ = x.shape
    n = b * t * h * w
    if n > (2 ** 31 - 1) // MAX_CHANNELS:
        raise ValueError(f"{n} positions are too many for one launch")
    if packed is None:
        packed = pack_weights(*params)
    shapes = [(c,), (c,), (k * c, f), (f,), (9 * f, c), (c,)]
    if [tuple(p.shape) for p in packed] != shapes or any(
            p.dtype != torch.float32 or not p.is_contiguous()
            or p.device != x.device for p in packed):
        raise ValueError("packed weights must be pack_weights() of the "
                         "block's parameters, on x's device")
    ln_s, ln_b, w1p, b1f, w2p, b2f = packed
    lib = _build.load("temporal_net", _SIGNATURES)
    scratch = torch.empty((n, f), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtt_temporal_net_fwd(
            x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1p.data_ptr(),
            b1f.data_ptr(), w2p.data_ptr(), b2f.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, t, h, w, c, f, k,
            int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, "dtt_temporal_net_error_string", err,
                 "TemporalNet kernel")
    fused_temporal_net.launches += 1
    return out


fused_temporal_net.launches = 0
