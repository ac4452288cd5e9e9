"""The video transformers: TimeSformer-style ViT and the ViViT factorized
encoder (port of ``dist_tpu/models/backbones/video_transformer.py``).

Clips arrive ``(B, T, H, W, 3)``, as for every backbone of the port;
the stems patchify them with one convolution (weights ``(O, I, T, H,
W)``) into tokens ``(B, N, C)`` in ``(t, h, w)`` order. Parameters keep
the JAX package's names (``stem.conv1``, ``cls_token``, ``pos_embd``,
``layer_{i}.attn.to_qkv`` with the fused projection split ``[q | k |
v]``, ``norm_ffn`` ...), so ``models/backbones/convert.py`` carries a JAX
tree across name for name.

Precision follows the JAX package's rule: the activation dtype carries
the policy. Dense layers compute in their input's dtype; the attention
rounds ``q * scale`` to it, takes fp32 scores and an fp32 softmax cast
to v's dtype, and multiplies by v in v's dtype. In fp32 and float64
:func:`attend` hands the same math to ``F.scaled_dot_product_attention``
(``tests/test_torch_port_video_transformer.py`` holds both forms to
JAX). The LayerNorms are fp32 islands, but for the last norm of
``VideoTransformer`` and ``norm_out`` of ``FactorizedTransformer``,
plain flax LayerNorms whose output stays fp32. Every LayerNorm has eps
1e-6 and the FFN's GELU is the exact one.
"""

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.blocks import Conv3d, Linear
from dist_tpu_torch.models.base.blocks import LayerNorm as _LayerNorm
from dist_tpu_torch.models.base.models import (
    BACKBONE_REGISTRY,
    BRANCH_REGISTRY,
    STEM_REGISTRY,
)
from dist_tpu_torch.models.precision import island_dtype, maybe_bf16_input

INIT_STD = 0.02


def trunc_normal_(t, generator):
    """flax's ``truncated_normal(0.02)``: N(0, 0.02) cut at two standard
    deviations."""
    nn.init.trunc_normal_(t, 0.0, INIT_STD, -2 * INIT_STD, 2 * INIT_STD,
                          generator=generator)


def drop_rates(rate, n):
    """Stochastic-depth rates ``linspace(0, rate, n)`` in fp32."""
    return [float(r) for r in np.linspace(0.0, float(rate or 0.0), n,
                                          dtype=np.float32)]


def gelu(x):
    """The exact GELU as ``jax.nn.gelu(approximate=False)`` rounds it:
    ``0.5 * x * erfc(-x * sqrt(0.5))`` with each step in bf16 for a bf16
    ``x`` (``F.gelu`` rounds once and differs from it in 38 % of bf16
    values); ``F.gelu`` in fp32 and float64."""
    if x.dtype in (torch.float32, torch.float64):
        return F.gelu(x)

    def const(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return const(0.5) * x * torch.special.erfc(-x * const(0.5 ** 0.5))


class LayerNorm(_LayerNorm):
    """LayerNorm with eps 1e-6, computed in fp32 (float64 for a float64
    input). ``keep_dtype`` (the JAX package's ``fp32_island``) casts the
    result back to the input's dtype; without it (a plain flax
    LayerNorm) the result stays fp32. ``scale_init`` is the scale's
    initial value."""

    def __init__(self, dim, keep_dtype=True, scale_init=1.0):
        super().__init__(dim, eps=1e-6)
        self.keep_dtype = keep_dtype
        self.scale_init = scale_init

    def init_own(self, generator):
        self.weight.fill_(self.scale_init)

    def forward(self, x):
        y = F.layer_norm(x.to(island_dtype(x)), (x.shape[-1],), self.weight,
                         self.bias, self.eps)
        return y.to(x.dtype) if self.keep_dtype else y


class Dense(Linear):
    """flax's ``Dense``: the product in the input's dtype, rounded, then
    the bias added (rounded again in bf16; a fused ``addmm`` rounds once
    and reads 60 times farther from JAX in bf16)."""

    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


class Conv(Conv3d):
    """flax's ``Conv``: as :class:`Dense`, the bias added after the
    convolution's output is rounded."""

    def forward(self, x):
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is None:
            return y
        return y + self.bias.to(x.dtype).view(-1, *([1] * (y.dim() - 2)))


class TruncLinear(Dense):
    """A dense layer with a truncated-normal(0.02) kernel and zero bias."""

    def init_own(self, generator):
        trunc_normal_(self.weight, generator)
        self.bias.zero_()


class DropPath(nn.Module):
    """Stochastic depth over the batch axis (timm's): in training each
    sample's branch is kept with probability ``1 - rate`` and scaled by
    ``1 / (1 - rate)``; in eval mode, or at rate 0, the identity. The
    mask is drawn from ``generator``, or where that is None from torch's
    default generator of the input's device, which the train step seeds
    per step (``tasks/state.py::step_rng``)."""

    def __init__(self, rate=0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty((x.shape[0],) + (1,) * (x.dim() - 1),
                           device=x.device).bernoulli_(keep,
                                                       generator=self.generator)
        return x * mask.to(x.dtype) / keep


class _Patchify(nn.Module):
    """A ``(ts, p, p)`` convolution of stride ``(ts, p, p)`` (no padding):
    ``(B, T, H, W, 3)`` -> tokens ``(B, T/ts * H/p * W/p, C)``."""

    def __init__(self, cfg, tubelet):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        p, dim = int(bb.PATCH_SIZE), int(bb.NUM_FEATURES)
        self.tubelet = int(tubelet)
        self.conv1 = Conv(3, dim, (self.tubelet, p, p), (self.tubelet, p, p))

    def forward(self, x):
        # (B, T, H, W, 3) viewed as NCDHW is cuDNN's channels-last layout;
        # the output read back as (B, t, h, w, C) is contiguous
        x = self.conv1(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
        return x.reshape(x.shape[0], -1, x.shape[-1])


@STEM_REGISTRY.register()
class PatchEmbedStem(_Patchify):
    """Per-frame patchify (tubelet 1)."""

    def __init__(self, cfg):
        super().__init__(cfg, 1)


@STEM_REGISTRY.register()
class TubeletEmbeddingStem(_Patchify):
    """Tubelet patchify, ``TUBELET_SIZE`` frames (default 2)."""

    def __init__(self, cfg):
        super().__init__(cfg, cfg.VIDEO.BACKBONE.get("TUBELET_SIZE", 2))


def attend(q, k, v, scale, dropout=0.0):
    """Softmax attention of ``q`` ``(B, Lq, h, d)`` over ``k``, ``v``
    ``(B, Lk, h, d)`` with the JAX package's rounding: ``scale`` and ``q
    * scale`` in the input's dtype, fp32 scores (float64 for float64), the softmax
    cast to v's dtype, P·V in v's dtype. In fp32 and float64 that is
    ``F.scaled_dot_product_attention``'s math."""
    if q.dtype in (torch.float32, torch.float64):
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            dropout_p=dropout, scale=scale)
        return out.transpose(1, 2)
    wide = island_dtype(q)
    # JAX rounds the Python scale to q's dtype, then the product
    q = q * torch.full((), scale, dtype=q.dtype, device=q.device)
    att = torch.einsum("bihd,bjhd->bhij", q.to(wide), k.to(wide))
    att = torch.softmax(att, dim=-1).to(v.dtype)
    if dropout > 0:
        att = F.dropout(att, dropout)
    return torch.einsum("bhij,bjhd->bihd", att, v)


class _Attention(nn.Module):
    """qkv attention, joint or divided. ``forward(x)`` with ``x`` ``(B,
    1 + M, C)``, the cls token first: joint attention over every token;
    with ``groups=g`` and ``group_size=n`` (``M = g * n``), the cls token
    attends to every token while each group of ``n`` patch tokens attends
    within the group, with the cls token's k and v prepended."""

    def __init__(self, dim, num_heads, attn_dropout=0.0, ff_dropout=0.0):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.attn_dropout, self.ff_dropout = attn_dropout, ff_dropout
        self.to_qkv = TruncLinear(dim, 3 * dim)
        self.proj = TruncLinear(dim, dim)

    def forward(self, x, groups=None, group_size=None):
        h = self.num_heads
        hd = self.dim // h
        scale = hd ** -0.5
        drop = self.attn_dropout if self.training else 0.0
        q, k, v = (t.reshape(t.shape[0], t.shape[1], h, hd)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        if groups is None:
            out = attend(q, k, v, scale, drop)
        else:
            b, g, n = x.shape[0], groups, group_size
            cls_out = attend(q[:, :1], k, v, scale, drop)
            # each batch row's groups are consecutive (jnp.repeat over the
            # batch axis is repeat_interleave)
            ck = k[:, :1].repeat_interleave(g, dim=0)
            cv = v[:, :1].repeat_interleave(g, dim=0)
            k_ = torch.cat([ck, k[:, 1:].reshape(b * g, n, h, hd)], dim=1)
            v_ = torch.cat([cv, v[:, 1:].reshape(b * g, n, h, hd)], dim=1)
            out_ = attend(q[:, 1:].reshape(b * g, n, h, hd), k_, v_, scale,
                          drop)
            out = torch.cat([cls_out, out_.reshape(b, g * n, h, hd)], dim=1)
        out = self.proj(out.reshape(out.shape[0], out.shape[1], self.dim))
        if self.ff_dropout > 0:
            out = F.dropout(out, self.ff_dropout, self.training)
        return out


class _FeedForward(nn.Module):
    """``fc1`` -> exact GELU -> ``fc2``, dropout after each."""

    def __init__(self, dim, mult=4, ff_dropout=0.0):
        super().__init__()
        self.ff_dropout = ff_dropout
        self.fc1 = TruncLinear(dim, dim * mult)
        self.fc2 = TruncLinear(dim * mult, dim)

    def forward(self, x):
        x = gelu(self.fc1(x))
        if self.ff_dropout > 0:
            x = F.dropout(x, self.ff_dropout, self.training)
        x = self.fc2(x)
        if self.ff_dropout > 0:
            x = F.dropout(x, self.ff_dropout, self.training)
        return x


def _dropouts(bb):
    return (float(bb.get("ATTN_DROPOUT", 0.0) or 0.0),
            float(bb.get("FF_DROPOUT", 0.0) or 0.0))


@BRANCH_REGISTRY.register()
class BaseTransformerLayer(nn.Module):
    """Joint space-time block: ``x + attn(norm(x))``, then ``x +
    ffn(norm_ffn(x))``, each branch through stochastic depth."""

    def __init__(self, cfg, drop_path_rate=0.0):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        dim = int(bb.NUM_FEATURES)
        attn_drop, ff_drop = _dropouts(bb)
        self.norm = LayerNorm(dim)
        self.attn = _Attention(dim, int(bb.NUM_HEADS), attn_drop, ff_drop)
        self.norm_ffn = LayerNorm(dim)
        self.ffn = _FeedForward(dim, int(bb.get("MLP_MULT", 4) or 4), ff_drop)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm(x)))
        return x + self.drop_path(self.ffn(self.norm_ffn(x)))


@BRANCH_REGISTRY.register()
class TimesformerLayer(nn.Module):
    """Divided space-time block: temporal attention (a group per patch
    position, its ``f`` frames), spatial attention (a group per frame,
    its ``n`` patches), then the FFN (``MLP_MULT`` is not read: 4).
    ``f`` is ``NUM_INPUT_FRAMES // TUBELET_SIZE`` (default 1) and ``n``
    comes from the token count, so any crop groups right."""

    def __init__(self, cfg, drop_path_rate=0.0):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        dim, heads = int(bb.NUM_FEATURES), int(bb.NUM_HEADS)
        attn_drop, ff_drop = _dropouts(bb)
        self.frames = int(cfg.DATA.NUM_INPUT_FRAMES) // int(
            bb.get("TUBELET_SIZE", 1) or 1)
        self.norm_temporal = LayerNorm(dim)
        self.attn_temporal = _Attention(dim, heads, attn_drop, ff_drop)
        self.norm = LayerNorm(dim)
        self.attn = _Attention(dim, heads, attn_drop, ff_drop)
        self.norm_ffn = LayerNorm(dim)
        self.ffn = _FeedForward(dim, 4, ff_drop)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x):
        f = self.frames
        n = (x.shape[1] - 1) // f
        if x.shape[1] - 1 != f * n:
            raise ValueError(f"{x.shape[1] - 1} patch tokens for {f} frames")

        def regroup(t, a, b):
            # the patch tokens (a, b) -> (b, a); the cls token stays first
            rest = t[:, 1:].reshape(t.shape[0], a, b, t.shape[2])
            return torch.cat([t[:, :1], rest.transpose(1, 2).reshape(
                t.shape[0], a * b, t.shape[2])], dim=1)

        h = regroup(self.norm_temporal(x), f, n)
        h = self.attn_temporal(h, groups=n, group_size=f)
        x = x + self.drop_path(regroup(h, n, f))
        h = self.attn(self.norm(x), groups=f, group_size=n)
        x = x + self.drop_path(h)
        return x + self.drop_path(self.ffn(self.norm_ffn(x)))


def resize_weights(n_in, n_out):
    """The ``(n_in, n_out)`` matrix of ``jax.image.resize``'s "bilinear"
    along one axis: half-pixel centres, and when shrinking the triangle
    kernel widened by ``n_in / n_out`` (antialiasing); each column's
    weights normalised to sum 1. Computed in float64."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def resize_grid(grid, side):
    """``grid`` ``(N, s, s, C)`` resized to ``(N, side, side, C)`` as
    ``jax.image.resize(grid, ..., "bilinear")`` resizes it, in either
    direction; the weights are cast to the grid's dtype."""
    s = grid.shape[1]
    if s == side:
        return grid
    w = torch.from_numpy(resize_weights(s, side)).to(grid.device, grid.dtype)
    return torch.einsum("nhwc,hi,wj->nijc", grid, w, w)


def _resized_pos(pos, frames, side0, side1):
    """``pos`` ``(1, 1 + frames * side0^2, C)``: the cls entry, then each
    frame's ``side0 x side0`` grid resized to ``side1 x side1``."""
    if side0 == side1:
        return pos
    dim = pos.shape[-1]
    grid = resize_grid(pos[:, 1:].reshape(frames, side0, side0, dim), side1)
    return torch.cat([pos[:, :1], grid.reshape(1, -1, dim)], dim=1)


def _side(n):
    return int(round(n ** 0.5))


@BACKBONE_REGISTRY.register(name="Transformer")
class VideoTransformer(nn.Module):
    """TimeSformer-style video ViT: the stem's tokens, the cls token, the
    position table (sized at ``TRAIN_CROP_SIZE``; at another crop each
    frame's grid is resized as JAX resizes it), ``DEPTH`` layers of the
    configured branch (stochastic depth ``linspace(0, DROP_PATH,
    DEPTH)``), the plain final ``norm``; returns the cls feature ``(B,
    NUM_FEATURES)``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        dim = self.out_dim = int(bb.NUM_FEATURES)
        self.patch = int(bb.PATCH_SIZE)
        self.train_per_frame = (int(cfg.DATA.TRAIN_CROP_SIZE) // self.patch) ** 2
        self.stem = STEM_REGISTRY.get_strict(bb.STEM.NAME)(cfg)
        frames = int(cfg.DATA.NUM_INPUT_FRAMES) // self.stem.tubelet
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embd = nn.Parameter(torch.empty(
            1, frames * self.train_per_frame + 1, dim))
        self.depth = int(bb.DEPTH)
        branch_cls = BRANCH_REGISTRY.get_strict(bb.BRANCH.NAME)
        for i, rate in enumerate(drop_rates(bb.get("DROP_PATH", 0.0),
                                            self.depth)):
            self.add_module(f"layer_{i}", branch_cls(cfg, drop_path_rate=rate))
        self.norm = LayerNorm(dim, keep_dtype=False)

    def init_own(self, generator):
        trunc_normal_(self.cls_token, generator)
        trunc_normal_(self.pos_embd, generator)

    def forward(self, x):
        if isinstance(x, dict):
            x = x["video"]
        x = maybe_bf16_input(self.cfg, x)
        p = self.patch
        n_per_frame = (x.shape[2] // p) * (x.shape[3] // p)
        x = self.stem(x)
        b, num_patches, dim = x.shape
        frames = num_patches // n_per_frame
        x = torch.cat([self.cls_token.expand(b, 1, dim).to(x.dtype), x], dim=1)
        pos = _resized_pos(self.pos_embd, frames, _side(self.train_per_frame),
                           _side(n_per_frame))
        x = x + pos.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"layer_{i}")(x)
        return self.norm(x)[:, 0]


@BACKBONE_REGISTRY.register()
class FactorizedTransformer(nn.Module):
    """ViViT factorized encoder: ``DEPTH`` spatial layers over each frame's
    tokens (with a cls token and a per-frame position table, resized at
    another crop), the ``norm`` island's cls outputs as the frames'
    tokens, then ``DEPTH_TEMP`` (default 4) temporal layers over them with
    ``cls_token_out`` and ``temp_embd``, and the plain ``norm_out``.
    Frames are counted ``NUM_INPUT_FRAMES // TUBELET_SIZE`` (default 1)."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        dim = self.out_dim = int(bb.NUM_FEATURES)
        self.patch = int(bb.PATCH_SIZE)
        self.tubelet = int(bb.get("TUBELET_SIZE", 1) or 1)
        self.train_per_frame = (int(cfg.DATA.TRAIN_CROP_SIZE) // self.patch) ** 2
        frames = int(cfg.DATA.NUM_INPUT_FRAMES) // self.tubelet
        self.stem = STEM_REGISTRY.get_strict(bb.STEM.NAME)(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embd = nn.Parameter(torch.empty(1, self.train_per_frame + 1,
                                                 dim))
        self.depth = int(bb.DEPTH)
        self.depth_temp = int(bb.get("DEPTH_TEMP", 4))
        rates = drop_rates(bb.get("DROP_PATH", 0.0),
                           self.depth + self.depth_temp)
        branch_cls = BRANCH_REGISTRY.get_strict(bb.BRANCH.NAME)
        for i in range(self.depth):
            self.add_module(f"layer_{i}",
                            branch_cls(cfg, drop_path_rate=rates[i]))
        self.norm = LayerNorm(dim)
        self.cls_token_out = nn.Parameter(torch.empty(1, 1, dim))
        self.temp_embd = nn.Parameter(torch.empty(1, frames + 1, dim))
        for i in range(self.depth_temp):
            self.add_module(f"layer_temporal_{i}", branch_cls(
                cfg, drop_path_rate=rates[self.depth + i]))
        self.norm_out = LayerNorm(dim, keep_dtype=False)

    def init_own(self, generator):
        for p in (self.cls_token, self.pos_embd, self.cls_token_out,
                  self.temp_embd):
            trunc_normal_(p, generator)

    def forward(self, x):
        if isinstance(x, dict):
            x = x["video"]
        x = maybe_bf16_input(self.cfg, x)
        p = self.patch
        frames = x.shape[1] // self.tubelet
        n_per_frame = (x.shape[2] // p) * (x.shape[3] // p)
        x = self.stem(x)
        b, _, dim = x.shape
        x = x.reshape(b * frames, n_per_frame, dim)
        x = torch.cat([self.cls_token.expand(x.shape[0], 1, dim).to(x.dtype),
                       x], dim=1)
        pos = _resized_pos(self.pos_embd, 1, _side(self.train_per_frame),
                           _side(n_per_frame))
        x = x + pos.to(x.dtype)
        for i in range(self.depth):
            x = getattr(self, f"layer_{i}")(x)
        x = self.norm(x)[:, 0].reshape(b, frames, dim)
        x = torch.cat([self.cls_token_out.expand(b, 1, dim).to(x.dtype), x],
                      dim=1)
        x = x + self.temp_embd.to(x.dtype)
        for i in range(self.depth_temp):
            x = getattr(self, f"layer_temporal_{i}")(x)
        return self.norm_out(x)[:, 0]
