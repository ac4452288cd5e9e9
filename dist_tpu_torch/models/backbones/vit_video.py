"""VideoMAE-style tubelet ViT: the encoder, the masked encoder and the
reconstruction decoder (port of ``dist_tpu/models/backbones/vit_video.py``).

The position table is the fixed sin-cos one, computed in float64 numpy
and cast to fp32. The masked encoder keeps ``round(N * (1 - MASK_RATIO))``
tokens (at least one), those of the smallest ``noise``: the caller may
hand the noise ``(B, N)`` across (the tests hand JAX's), else it is
drawn uniform from ``generator`` (None: torch's default generator).
"""

import numpy as np
import torch
import torch.nn as nn

from dist_tpu_torch.models.backbones.video_transformer import (
    BaseTransformerLayer,
    Dense,
    LayerNorm,
    TubeletEmbeddingStem,
    trunc_normal_,
)
from dist_tpu_torch.models.base.models import BACKBONE_REGISTRY
from dist_tpu_torch.models.precision import maybe_bf16_input


def sincos_pos_embed(n, dim):
    """The fixed sin-cos table ``(1, n, dim)`` (VideoMAE's
    ``get_sinusoid_encoding``), in float64 then fp32."""
    pos = np.arange(n)[:, None]
    omega = np.power(10000, 2 * (np.arange(dim) // 2) / dim)
    table = pos / omega[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return torch.from_numpy(table[None].astype(np.float32))


class _Blocks(nn.Module):
    """``layer_0`` ... ``layer_{depth-1}``, joint-attention layers without
    stochastic depth."""

    def __init__(self, cfg, depth):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"layer_{i}", BaseTransformerLayer(cfg))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"layer_{i}")(x)
        return x


def _table(n, dim, like):
    return sincos_pos_embed(n, dim).to(like.device)


@BACKBONE_REGISTRY.register()
class VitVideoEncoder(nn.Module):
    """Tubelet tokens plus the sin-cos table, ``DEPTH`` layers, the plain
    ``norm``; returns the tokens' mean ``(B, NUM_FEATURES)``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.out_dim = int(cfg.VIDEO.BACKBONE.NUM_FEATURES)
        self.stem = TubeletEmbeddingStem(cfg)
        self.blocks = _Blocks(cfg, int(cfg.VIDEO.BACKBONE.DEPTH))
        self.norm = LayerNorm(self.out_dim, keep_dtype=False)

    def forward(self, x):
        if isinstance(x, dict):
            x = x["video"]
        x = self.stem(maybe_bf16_input(self.cfg, x))
        x = x + _table(x.shape[1], x.shape[2], x).to(x.dtype)
        return self.norm(self.blocks(x)).mean(dim=1)


@BACKBONE_REGISTRY.register()
class VitVideoMAEEncoder(nn.Module):
    """The masked encoder: encodes the visible tokens only. ``forward(x,
    noise=None, generator=None) -> (latent, ids_restore)``: ``latent``
    ``(B, n_keep, C)`` after the plain ``norm``, ``ids_restore`` ``(B,
    N)`` the argsort of the noise's argsort."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        self.out_dim = int(bb.NUM_FEATURES)
        self.ratio = float(bb.get("MASK_RATIO", 0.9))
        self.stem = TubeletEmbeddingStem(cfg)
        self.blocks = _Blocks(cfg, int(bb.DEPTH))
        self.norm = LayerNorm(self.out_dim, keep_dtype=False)

    def forward(self, x, noise=None, generator=None):
        if isinstance(x, dict):
            x = x["video"]
        x = self.stem(maybe_bf16_input(self.cfg, x))
        b, n, c = x.shape
        x = x + _table(n, c, x).to(x.dtype)
        n_keep = max(1, int(round(n * (1.0 - self.ratio))))
        if noise is None:
            noise = torch.rand((b, n), generator=generator, device=x.device)
        ids_shuffle = torch.argsort(noise, dim=1, stable=True)
        ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
        keep = ids_shuffle[:, :n_keep]
        x = torch.gather(x, 1, keep[:, :, None].expand(-1, -1, c))
        return self.norm(self.blocks(x)), ids_restore


@BACKBONE_REGISTRY.register()
class VitVideoMAEDecoder(nn.Module):
    """The reconstruction decoder: ``embed`` to ``DECODER_DIM`` (default
    384), ``mask_token`` at the masked places, the tokens put back in
    order by ``ids_restore``, the fp32 sin-cos table, ``DECODER_DEPTH``
    (default 4) layers of ``DECODER_DIM // 64`` heads, the plain
    ``norm``, and ``pred`` to ``PATCH_SIZE^2 * TUBELET_SIZE * 3``
    pixels."""

    def __init__(self, cfg):
        super().__init__()
        bb = cfg.VIDEO.BACKBONE
        dec_dim = int(bb.get("DECODER_DIM", 384))
        ts = int(bb.get("TUBELET_SIZE", 2))
        p = int(bb.PATCH_SIZE)
        self.dec_dim = dec_dim
        self.embed = Dense(int(bb.NUM_FEATURES), dec_dim)
        self.mask_token = nn.Parameter(torch.empty(1, 1, dec_dim))
        dec_cfg = cfg.deep_copy()
        dec_cfg.VIDEO.BACKBONE.NUM_FEATURES = dec_dim
        dec_cfg.VIDEO.BACKBONE.NUM_HEADS = max(dec_dim // 64, 1)
        self.blocks = _Blocks(dec_cfg, int(bb.get("DECODER_DEPTH", 4)))
        self.norm = LayerNorm(dec_dim, keep_dtype=False)
        self.pred = Dense(dec_dim, p * p * ts * 3)

    def init_own(self, generator):
        trunc_normal_(self.mask_token, generator)

    def forward(self, latent, ids_restore):
        b, n_vis, _ = latent.shape
        n = ids_restore.shape[1]
        x = self.embed(latent)
        x = torch.cat([x, self.mask_token.expand(b, n - n_vis, self.dec_dim)],
                      dim=1)
        x = torch.gather(x, 1, ids_restore[:, :, None].expand(
            -1, -1, self.dec_dim))
        # the fp32 table is added as is: a bf16 x is promoted
        x = x + _table(n, self.dec_dim, x)
        return self.pred(self.norm(self.blocks(x)))
