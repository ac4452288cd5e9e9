"""Fused DiST TemporalNet block, forward and backward.

Port of ``dist_tpu/ops/temporal_net.py``. The ladder's temporal block

    out = qgelu(x + conv(1,3,3)(qgelu(conv(k,1,1)(LN(x)) + b1)) + b2)

runs on channels-last x (B, T, H, W, C) with LayerNorm eps 1e-5, fp32
inside and the output in x's dtype. The signature and weight layouts are
the JAX package's: raw kernels ``w1 (k,1,1,C,F)`` and ``w2 (1,3,3,F,C)``.

Forward: on a CUDA tensor :func:`fused_temporal_net` launches the
hand-written kernel K2 of ``csrc/temporal_net.cu`` (a few launches through
a scratch the wrapper allocates; one call, one count), or raises. Its
route follows x's dtype (:func:`temporal_net_fwd_route`): float32 runs on
the CUDA cores, bf16 (the served and trained model's) on the tensor cores,
from the stages of K3's bf16 route, with bf16 product operands and fp32
sums and elementwise steps. On a CPU tensor it runs
:func:`temporal_net_plain`, which mirrors ``_reference`` / ``_chain_fwd``:
each conv tap is a shifted view of the zero-padded activations times one
(C, F) weight block.

Backward: :func:`fused_temporal_net_bwd` launches K3 (the same source; it
recomputes the forward, as ``_bwd_kernel`` does) or, on a CPU tensor,
runs :func:`temporal_net_bwd_plain`. K3's route follows x's dtype
(:func:`temporal_net_bwd_route`): float32 runs on the CUDA cores, bf16 (the
train step's) on the tensor cores with bf16 product operands and fp32
sums and elementwise steps. :func:`temporal_net` joins the two in a
``torch.autograd.Function`` that saves only x and the parameters.
"""

import ctypes

import torch
import torch.nn.functional as F

from dist_tpu_torch.ops import _build

EPS = 1e-5
MAX_CHANNELS = 128

_SIGNATURES = {
    "dtt_temporal_net_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p],
    "dtt_temporal_net_bwd": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9
                            + [ctypes.c_void_p],
    "dtt_temporal_net_occupancy": [ctypes.c_int] * 3
                                  + [ctypes.POINTER(ctypes.c_int)] * 2,
    "dtt_temporal_net_error_string": [ctypes.c_int],
}
# K3 sums its weight-gradient partials over this many fixed chunks of
# positions (csrc/temporal_net.cu, kBwdChunks and k3::kChunks), and its
# other partials over tiles of BWD_TILE positions (fp32 route, BM) or
# BWD_MMA_TILE (bf16 route, k3::BM)
BWD_CHUNKS = 32
BWD_TILE = 64
BWD_MMA_TILE = 128
# the bf16 routes' kernels, in the order the occupancy entry numbers them:
# K3's, then K2's
BWD_MMA_KERNELS = ("stage_A", "stage_B", "stage_C", "stage_D",
                   "weight_grads")
FWD_MMA_KERNELS = ("stage_Af", "stage_F")


def _qgelu(x):
    return x * torch.sigmoid(1.702 * x)


def _qgelu_grad(x):
    s = torch.sigmoid(1.702 * x)
    return s * (1.0 + 1.702 * x * (1.0 - s))


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


def _chain_fwd(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2):
    """The block's forward in fp32 (``_chain_fwd`` of the JAX package):
    -> (r, g, hb, xlp, z, rstd) with out = qgelu(r), g = qgelu(hb) and
    xlp = LN(x) with k // 2 zero frames on each side."""
    k, c, f = check_shapes(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2)
    t, h, w = x.shape[1:4]
    pad = k // 2
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + EPS)
    z = xc * rstd
    xl = z * ln_s.float() + ln_b.float()
    w1 = w1_raw.float().reshape(k, c, f)
    xlp = F.pad(xl, (0, 0, 0, 0, 0, 0, pad, pad))       # zero frames outside T
    hb = xlp[:, 0:t] @ w1[0]
    for d in range(1, k):
        hb = hb + xlp[:, d:d + t] @ w1[d]
    hb = hb + b1.float()
    g = _qgelu(hb)
    w2 = w2_raw.float().reshape(3, 3, f, c)
    gp = F.pad(g, (0, 0, 1, 1, 1, 1))                    # zero pixels outside
    acc = gp[:, :, 0:h, 0:w] @ w2[0, 0]
    for tap in range(1, 9):
        dy, dx = divmod(tap, 3)
        acc = acc + gp[:, :, dy:dy + h, dx:dx + w] @ w2[dy, dx]
    return xf + acc + b2.float(), g, hb, xlp, z, rstd


def temporal_net_plain(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2):
    """Plain PyTorch version of the block; the CPU path and K2's
    yardstick."""
    r = _chain_fwd(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2)[0]
    return _qgelu(r).to(x.dtype)


def temporal_net_bwd_plain(x, g, ln_s, ln_b, w1_raw, b1, w2_raw, b2):
    """Plain PyTorch version of the block's gradient for the cotangent
    ``g`` of its output; the CPU path and K3's yardstick. Follows
    ``_bwd_kernel`` step by step in fp32 and returns (dx in x's dtype,
    d ln_scale, d ln_bias, dw1 (k,1,1,C,F), db1, dw2 (1,3,3,F,C), db2),
    each weight gradient summed in fp32 and cast to its parameter's
    dtype."""
    k, c, f = check_shapes(x, ln_s, ln_b, w1_raw, b1, w2_raw, b2)
    if tuple(g.shape) != tuple(x.shape):
        raise ValueError(f"the cotangent {tuple(g.shape)} must have x's "
                         f"shape {tuple(x.shape)}")
    t, h, w = x.shape[1:4]
    pad = k // 2
    # 1. recompute the forward
    r, gg, hb, xlp, z, rstd = _chain_fwd(x, ln_s, ln_b, w1_raw, b1, w2_raw,
                                         b2)
    # 2. through the output's qgelu; the spatial conv's bias and taps
    dr = _qgelu_grad(r) * g.float()
    db2 = dr.sum(dim=(0, 1, 2, 3))
    gp = F.pad(gg, (0, 0, 1, 1, 1, 1))
    dr2 = dr.reshape(-1, c)
    dw2 = torch.stack([
        gp[:, :, dy:dy + h, dx:dx + w].reshape(-1, f).T @ dr2
        for dy in range(3) for dx in range(3)]).reshape(1, 3, 3, f, c)
    # 3. dg through the transposed 3x3 taps: each tap's product lands at
    #    the pixel it was read from (zero-padded image, cropped after)
    w2 = w2_raw.float().reshape(3, 3, f, c)
    dgp = torch.zeros_like(gp)
    for dy in range(3):
        for dx in range(3):
            dgp[:, :, dy:dy + h, dx:dx + w] += dr @ w2[dy, dx].T
    dg = dgp[:, :, 1:h + 1, 1:w + 1]
    # 4. through g = qgelu(hb); the temporal conv's bias and taps
    dhb = _qgelu_grad(hb) * dg
    db1 = dhb.sum(dim=(0, 1, 2, 3))
    dhb2 = dhb.reshape(-1, f)
    dw1 = torch.stack([xlp[:, d:d + t].reshape(-1, c).T @ dhb2
                       for d in range(k)]).reshape(k, 1, 1, c, f)
    # 5. dxl through the transposed temporal taps; the zero frames outside
    #    T take no gradient
    w1 = w1_raw.float().reshape(k, c, f)
    dxlp = torch.zeros_like(xlp)
    for d in range(k):
        dxlp[:, d:d + t] += dhb @ w1[d].T
    dxl = dxlp[:, pad:pad + t]
    # 6. LayerNorm backward
    dlns = (dxl * z).sum(dim=(0, 1, 2, 3))
    dlnb = dxl.sum(dim=(0, 1, 2, 3))
    dz = dxl * ln_s.float()
    mean_dz = dz.mean(dim=-1, keepdim=True)
    mean_dzz = (dz * z).mean(dim=-1, keepdim=True)
    dx_ln = rstd * (dz - mean_dz - z * mean_dzz)
    # 7. both paths to x
    dx = (dr + dx_ln).to(x.dtype)
    return (dx, dlns.to(ln_s.dtype), dlnb.to(ln_b.dtype),
            dw1.to(w1_raw.dtype), db1.to(b1.dtype), dw2.to(w2_raw.dtype),
            db2.to(b2.dtype))


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


def _check_cuda(x, params, c, f):
    """Entry checks of the kernels on a CUDA tensor x; returns N."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if any(p.device != x.device for p in params):
        raise ValueError("the block's parameters must be on x's device")
    if c > MAX_CHANNELS or f > MAX_CHANNELS:
        raise ValueError(f"C={c} and F={f} must be <= {MAX_CHANNELS}")
    n = x.numel() // c
    if n > (2 ** 31 - 1) // MAX_CHANNELS:
        raise ValueError(f"{n} positions are too many for one launch")
    return n


def _check_bf16_widths(dtype, c, f):
    """The bf16 routes move rows of 8 channels as 16-byte copies."""
    if dtype == torch.bfloat16 and (c % 8 or f % 8):
        raise ValueError(f"the bf16 kernel moves rows of 8 channels: C={c} "
                         f"and F={f} must be multiples of 8")


def fused_temporal_net(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2,
                       packed=None):
    """TemporalNet block on x (B, T, H, W, C). CUDA tensor: the
    hand-written kernel K2 on the route :func:`temporal_net_fwd_route`
    names, on ``packed`` (:func:`pack_weights` of the same parameters; the
    bf16 route packs its own bf16 tiles from them in each call) or on
    weights packed for this call; CPU tensor: :func:`temporal_net_plain`.
    Not differentiable itself: see :func:`temporal_net`."""
    k, c, f = check_shapes(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    if x.device.type == "cpu":
        return temporal_net_plain(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    params = (ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    n = _check_cuda(x, params, c, f)
    _check_bf16_widths(x.dtype, c, f)
    if fwd_scratch_floats(n, c, f, k, x.dtype) > 2 ** 31 - 1:
        raise ValueError(f"{n} positions are too many for one launch")
    if packed is None:
        packed = pack_weights(*params)
    shapes = [(c,), (c,), (k * c, f), (f,), (9 * f, c), (c,)]
    if [tuple(p.shape) for p in packed] != shapes or any(
            p.dtype != torch.float32 or not p.is_contiguous()
            or p.device != x.device for p in packed):
        raise ValueError("packed weights must be pack_weights() of the "
                         "block's parameters, on x's device")
    out = launch_fwd(_build.load("temporal_net", _SIGNATURES), x, packed)
    fused_temporal_net.launches += 1
    return out


def launch_fwd(lib, x, packed):
    """One launch of ``dtt_temporal_net_fwd`` from the library ``lib`` on
    x and its :func:`pack_weights`, checked by :func:`fused_temporal_net`;
    counts nothing."""
    ln_s, ln_b, w1p, b1f, w2p, b2f = packed
    c, f = ln_s.shape[0], w1p.shape[1]
    k = w1p.shape[0] // c
    b, t, h, w, _ = x.shape
    nscratch = fwd_scratch_floats(b * t * h * w, c, f, k, x.dtype)
    scratch = torch.empty(nscratch, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtt_temporal_net_fwd(
            x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), w1p.data_ptr(),
            b1f.data_ptr(), w2p.data_ptr(), b2f.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), b, t, h, w, c, f, k,
            int(x.dtype == torch.bfloat16), nscratch, stream)
    _build.check(lib, "dtt_temporal_net_error_string", err,
                 "TemporalNet kernel")
    return out


fused_temporal_net.launches = 0


def temporal_net_fwd_route(dtype):
    """K2's route for x's dtype, by the rule ``csrc/temporal_net.cu``
    applies: ``"bf16_mma"`` (tensor cores) for bfloat16, ``"fp32"`` (CUDA
    cores) for float32."""
    return "bf16_mma" if dtype == torch.bfloat16 else "fp32"


def temporal_net_bwd_route(dtype):
    """K3's route for x's dtype, by the rule ``csrc/temporal_net.cu``
    applies: ``"bf16_mma"`` (tensor cores) for bfloat16, ``"fp32"`` (CUDA
    cores) for float32."""
    return "bf16_mma" if dtype == torch.bfloat16 else "fp32"


def _padded(c, f):
    """The bf16 route's channel padding (k3::padded): max(C, F) rounded up
    to a multiple of 32."""
    return 32 * -(-max(c, f) // 32)


def fwd_scratch_floats(n, c, f, k, dtype=torch.float32):
    """fp32 scratch of one K2 call on n positions, laid out as the C side
    lays it out for ``dtype``'s route. fp32: the fp32 g (n, F). bf16
    (``k3::FwdLayout``; a bf16 array takes half a float per element): the
    k + 9 forward weight tiles, LN(x) and g, all bf16."""
    if temporal_net_fwd_route(dtype) == "fp32":
        return n * f
    p = _padded(c, f)
    return (k + 9) * p * p // 2 + n * c // 2 + n * f // 2


def bwd_scratch_floats(n, c, f, k, dtype=torch.float32):
    """fp32 scratch of one K3 call on n positions, laid out as the C side
    lays it out for ``dtype``'s route. fp32 (``BwdLayout``): hb, g, dr, dhb,
    the weight-gradient partials of BWD_CHUNKS chunks and the LayerNorm
    partials of each 64-position tile. bf16 (``k3::Layout``; a bf16 array
    takes half a float per element): the packed weight tiles, LN(x), g, dr
    and dhb in bf16, hb and dr in fp32, the weight-gradient partials and
    the bias and LayerNorm partials of each 128-position tile."""
    if temporal_net_bwd_route(dtype) == "fp32":
        tiles = -(-n // BWD_TILE)
        return (n * (3 * f + c)
                + BWD_CHUNKS * (k * c * f + 9 * f * c + f + c)
                + 2 * tiles * c)
    p = _padded(c, f)
    tiles = -(-n // BWD_MMA_TILE)
    return ((2 * k + 18) * p * p // 2 + 2 * n * (c + f)
            + BWD_CHUNKS * (k + 9) * c * f + tiles * (f + 3 * c))


def _occupancy(c, f, names, first):
    lib = _build.load("temporal_net", _SIGNATURES)
    out = {}
    for which, name in enumerate(names, first):
        blocks, nbytes = ctypes.c_int(), ctypes.c_int()
        err = lib.dtt_temporal_net_occupancy(
            c, f, which, ctypes.byref(blocks), ctypes.byref(nbytes))
        _build.check(lib, "dtt_temporal_net_error_string", err,
                     "TemporalNet occupancy")
        out[name] = {"blocks_per_sm": blocks.value,
                     "smem_bytes": nbytes.value}
    return out


def bwd_occupancy(c, f):
    """{kernel: {"blocks_per_sm", "smem_bytes"}} of K3's bf16 route at
    channels (C, F): blocks resident on one SM from CUDA's occupancy
    calculator and dynamic shared memory per block (needs the card)."""
    return _occupancy(c, f, BWD_MMA_KERNELS, 0)


def fwd_occupancy(c, f):
    """:func:`bwd_occupancy` of K2's bf16 route: its stage kernels."""
    return _occupancy(c, f, FWD_MMA_KERNELS, len(BWD_MMA_KERNELS))


def fused_temporal_net_bwd(x, g, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2):
    """The block's gradient for the cotangent ``g`` of its output, in the
    order and layouts of :func:`temporal_net_bwd_plain`. CUDA tensor: the
    hand-written kernel K3 (a few launches behind one count) on the route
    :func:`temporal_net_bwd_route` names; CPU tensor:
    :func:`temporal_net_bwd_plain`."""
    k, c, f = check_shapes(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    if x.device.type == "cpu":
        return temporal_net_bwd_plain(x, g, ln_scale, ln_bias, w1_raw, b1,
                                      w2_raw, b2)
    params = (ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
    n = _check_cuda(x, params, c, f)
    if (tuple(g.shape) != tuple(x.shape) or g.dtype != x.dtype
            or g.device != x.device or not g.is_contiguous()):
        raise ValueError("the cotangent must be contiguous, with x's shape, "
                         "type and device")
    _check_bf16_widths(x.dtype, c, f)
    if bwd_scratch_floats(n, c, f, k, x.dtype) > 2 ** 31 - 1:
        raise ValueError(f"{n} positions are too many for one launch")
    out = launch_bwd(_build.load("temporal_net", _SIGNATURES), x, g, *params)
    fused_temporal_net_bwd.launches += 1
    return out


def launch_bwd(lib, x, g, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2):
    """One launch of ``dtt_temporal_net_bwd`` from the library ``lib`` on
    inputs :func:`fused_temporal_net_bwd` has checked; counts nothing."""
    k, c, f = w1_raw.shape[0], w1_raw.shape[-2], w1_raw.shape[-1]
    ln_s, ln_b, w1p, b1f, w2p, b2f = pack_weights(ln_scale, ln_bias, w1_raw,
                                                  b1, w2_raw, b2)
    if temporal_net_bwd_route(x.dtype) == "fp32":
        with torch.no_grad():
            w1t = w1p.reshape(k, c, f).transpose(1, 2).reshape(k * f, c)
            w2t = w2p.reshape(9, f, c).transpose(1, 2).reshape(9 * c, f)
            w1t, w2t = w1t.contiguous(), w2t.contiguous()
        w1t_ptr, w2t_ptr = w1t.data_ptr(), w2t.data_ptr()
    else:       # the bf16 route packs its own bf16 tiles from w1p and w2p
        w1t_ptr = w2t_ptr = None
    b, t, h, w, _ = x.shape
    nscratch = bwd_scratch_floats(b * t * h * w, c, f, k, x.dtype)
    scratch = torch.empty(nscratch, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    f32 = dict(dtype=torch.float32, device=x.device)
    dlns, dlnb, db2 = (torch.empty(c, **f32) for _ in range(3))
    db1 = torch.empty(f, **f32)
    dw1 = torch.empty((k * c, f), **f32)
    dw2 = torch.empty((9 * f, c), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dtt_temporal_net_bwd(
            x.data_ptr(), g.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
            w1p.data_ptr(), w1t_ptr, b1f.data_ptr(), w2p.data_ptr(),
            w2t_ptr, b2f.data_ptr(), scratch.data_ptr(),
            dx.data_ptr(), dlns.data_ptr(), dlnb.data_ptr(), dw1.data_ptr(),
            db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(),
            b, t, h, w, c, f, k, int(x.dtype == torch.bfloat16), nscratch,
            stream)
    _build.check(lib, "dtt_temporal_net_error_string", err,
                 "TemporalNet backward kernel")
    return (dx, dlns.to(ln_scale.dtype), dlnb.to(ln_bias.dtype),
            dw1.reshape(k, 1, 1, c, f).to(w1_raw.dtype), db1.to(b1.dtype),
            dw2.reshape(1, 3, 3, f, c).to(w2_raw.dtype), db2.to(b2.dtype))


fused_temporal_net_bwd.launches = 0


class _TemporalNetFunction(torch.autograd.Function):
    """Forward through K2, backward through K3. Saves x and the parameters
    only: K3 recomputes the activations, as the TPU kernel does."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2)
        return fused_temporal_net(x, ln_scale, ln_bias, w1_raw, b1, w2_raw,
                                  b2)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        return fused_temporal_net_bwd(x, g.to(x.dtype).contiguous(), *params)


def temporal_net(x, ln_scale, ln_bias, w1_raw, b1, w2_raw, b2):
    """The differentiable block: :func:`fused_temporal_net` forward and
    :func:`fused_temporal_net_bwd` backward. The gradients come back in the
    raw layouts, so autograd carries them through any view (such as the
    ``permute`` of a torch conv weight) the parameters were passed as."""
    return _TemporalNetFunction.apply(x, ln_scale, ln_bias, w1_raw, b1,
                                      w2_raw, b2)
