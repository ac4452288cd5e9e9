"""DiST side network (port of ``dist_tpu/models/dist/dist_net.py``).

A dense temporal 3D-conv stream over all T frames and a per-CLIP-layer
integration ladder over the sparse t = T/alpha frames, fused both ways at
each step, finished by two cross-attention pooling layers. Parameters
carry the reference's torch names (``dist_net.temporal_nets.<i>.*``,
``dist_net.input_linears.<i>.*``, ...), one module per ladder step in
``nn.ModuleList``s; the JAX package's scan over stacked layers becomes a
loop.

Shapes (B videos, T dense frames, t = T/alpha sparse frames, L tokens):
  video  (B, T, H, W, 3)
  taps   (num_selected, B*t, L, d_model)  - CLIP block outputs
  out    (B, embed_dim)
The dense stream is channels-last (B, T, H', W', C) as in the JAX package.
"""

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from dist_tpu_torch.models.base.blocks import (
    Conv3d,
    CrossAttentionBlock,
    LayerNorm,
    Linear,
    MLP,
    quick_gelu,
)
from dist_tpu_torch.ops.temporal_net import (
    fused_temporal_net,
    pack_weights,
    temporal_net,
)


@dataclasses.dataclass(frozen=True)
class DiSTConfig:
    """Static hyperparameters (cfg.VIDEO.BACKBONE.DIST.*)."""

    selected_layers: Tuple[int, ...]
    temporal_dim: int = 96
    integration_dim: int = 384
    s_patch_size: int = 16
    t_patch_size: int = 5
    temporal_kernel_size: int = 3
    temporal_conv_mlp_ratio: float = 1.0
    integration_mlp_ratio: float = 1.0
    integration_temporal_mlp_ratio: float = 0.25
    ada_pooling_layers: int = 2
    num_frames: int = 16
    alpha: int = 2

    @classmethod
    def from_cfg(cls, cfg):
        d = cfg.VIDEO.BACKBONE.DIST
        if int(cfg.DATA.NUM_INPUT_FRAMES) % int(cfg.DATA.SPARSE_SAMPLE_ALPHA):
            raise ValueError(
                "NUM_INPUT_FRAMES must be divisible by SPARSE_SAMPLE_ALPHA "
                f"({cfg.DATA.NUM_INPUT_FRAMES} % {cfg.DATA.SPARSE_SAMPLE_ALPHA})"
                ": every t = T/alpha reshape in the ladder assumes it")
        return cls(
            selected_layers=tuple(d.SELECTED_LAYERS),
            temporal_dim=d.TEMPORAL_DIM,
            integration_dim=d.INTEGRATION_DIM,
            s_patch_size=d.S_PATCH_SIZE,
            t_patch_size=d.T_PATCH_SIZE,
            temporal_kernel_size=d.TEMPORAL_KERNEL_SIZE,
            temporal_conv_mlp_ratio=d.TEMPORAL_CONV_MLP_RATIO,
            integration_mlp_ratio=d.INTEGRATION_MLP_RATIO,
            integration_temporal_mlp_ratio=d.INTEGRATION_TEMPORAL_MLP_RATIO,
            ada_pooling_layers=d.ADA_POOLING_LAYERS,
            num_frames=cfg.DATA.NUM_INPUT_FRAMES,
            alpha=int(cfg.DATA.SPARSE_SAMPLE_ALPHA),
        )

    @property
    def sparse_frames(self):
        return self.num_frames // self.alpha


def _to_channels_first(x):     # (B, T, H, W, C) -> (B, C, T, H, W)
    return x.permute(0, 4, 1, 2, 3)


def _to_channels_last(x):      # (B, C, T, H, W) -> (B, T, H, W, C)
    return x.permute(0, 2, 3, 4, 1)


def _trunc_normal_(p, std, generator):
    """normal(0, std) clipped at 2 std (stands in for the JAX package's
    truncated normal in random weights)."""
    p.normal_(0.0, std, generator=generator).clamp_(-2 * std, 2 * std)


class TemporalPatchStem(Conv3d):
    """The dense temporal patch stem: a (tp, p, p) conv with stride
    (1, p, p) and temporal padding tp//2, on channels-last video."""

    channels_last_output = True

    def __init__(self, channels, t_patch, s_patch):
        super().__init__(3, channels, (t_patch, s_patch, s_patch),
                         stride=(1, s_patch, s_patch),
                         padding=(t_patch // 2, 0, 0))

    def forward(self, video):
        return _to_channels_last(super().forward(_to_channels_first(video)))


class TemporalNet(nn.Module):
    """Residual temporal conv block on (B, T, H, W, C):
    qgelu(x + conv(1,3,3)(qgelu(conv(k,1,1)(LN(x))))).

    ``fused``: run the whole block as the hand-written kernels
    (``ops/temporal_net.py``; K2 forward, K3 backward when grad is on);
    the parameters are the same either way. Under ``torch.no_grad()`` the
    forward kernel's packed weights are made once and again only after the
    parameters change (in place, as ``load_state_dict`` does, or by a move
    to another device or type). With grad on, the weights are packed on
    every call and the cached pack is dropped: an optimizer's in-place
    update need not bump the version counter the cache keys on.
    :meth:`freeze_packed` makes the pack buffers of the module instead,
    which ``torch.export`` traces (its fake tensors have no ``data_ptr``
    to key a cache on) and a saved program keeps as constants."""

    def __init__(self, cfg, fused=False):
        super().__init__()
        c = cfg.temporal_dim
        k = cfg.temporal_kernel_size
        hidden = int(c * cfg.temporal_conv_mlp_ratio)
        self.fused = fused
        self.ln = LayerNorm(c)
        self.temporal_net = nn.ModuleDict({
            "c_fc1": Conv3d(c, hidden, (k, 1, 1), padding=(k // 2, 0, 0)),
            "c_fc2": Conv3d(hidden, c, (1, 3, 3), padding=(0, 1, 1)),
        })
        self._packed, self._packed_key = None, None
        self._frozen = False
        # under FSDP the gathered weights' storage is freed and allocated
        # again at the same address with the same version, which the
        # cache's key cannot tell apart (parallel/fsdp.py)
        self.pack_every_call = False

    def _apply(self, fn, *args, **kwargs):
        self._packed, self._packed_key = None, None
        return super()._apply(fn, *args, **kwargs)

    def _raw_params(self):
        """The parameters in the kernel's order; torch (O, I, T, H, W)
        kernels as views in the raw (T, H, W, I, O) layout."""
        c_fc1, c_fc2 = self.temporal_net["c_fc1"], self.temporal_net["c_fc2"]
        return (self.ln.weight, self.ln.bias,
                c_fc1.weight.permute(2, 3, 4, 1, 0), c_fc1.bias,
                c_fc2.weight.permute(2, 3, 4, 1, 0), c_fc2.bias)

    def _packed_weights(self, params):
        if self.pack_every_call:
            return pack_weights(*params)
        key = tuple((p.data_ptr(), p._version, p.device) for p in params)
        if key != self._packed_key:
            self._packed, self._packed_key = pack_weights(*params), key
        return self._packed

    def freeze_packed(self):
        """Pack the kernel's weights once, into non-persistent buffers
        (``packed_0`` ... ``packed_5``) that every later call without grad
        takes as they are: for a model whose parameters no longer change,
        such as the one ``serving/export.py`` exports."""
        for i, p in enumerate(pack_weights(*self._raw_params())):
            self.register_buffer(f"packed_{i}", p.detach().clone(),
                                 persistent=False)
        self._frozen = True

    def forward(self, x):
        if self.fused:
            params = self._raw_params()
            if torch.is_grad_enabled():
                self._packed, self._packed_key = None, None
                return temporal_net(x.contiguous(), *params)
            packed = (tuple(getattr(self, f"packed_{i}") for i in range(6))
                      if self._frozen else self._packed_weights(params))
            return fused_temporal_net(x.contiguous(), *params, packed=packed)
        c_fc1, c_fc2 = self.temporal_net["c_fc1"], self.temporal_net["c_fc2"]
        h = _to_channels_first(self.ln(x))
        h = c_fc2(quick_gelu(c_fc1(h)))
        return quick_gelu(x + _to_channels_last(h))


class IntegrationNetwork(nn.Module):
    """Token MLP plus a temporal conv-FFN across the sparse frame axis over
    the integration tokens. Not residual: the caller adds the residual."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg.integration_dim
        k = cfg.temporal_kernel_size
        hidden = int(c * cfg.integration_temporal_mlp_ratio)
        self.t = cfg.sparse_frames
        self.ln = LayerNorm(c)
        self.ffn = MLP(c, int(c * cfg.integration_mlp_ratio), c)
        self.ln_temporal = LayerNorm(c)
        self.temporal_ffn = nn.ModuleDict({
            "c_fc1": Conv3d(c, hidden, 1),
            "c_fc2": Conv3d(hidden, hidden, (k, 1, 1), padding=(k // 2, 0, 0)),
            "c_proj": Conv3d(hidden, c, 1),
        })

    def forward(self, x):
        bt, l, c = x.shape
        b = bt // self.t
        ffn_out = self.ffn(self.ln(x))
        # convs over (t, L, 1), channels first: (B, C, t, L, 1)
        h = self.ln_temporal(x).reshape(b, self.t, l, c).permute(0, 3, 1, 2)
        h = h.unsqueeze(-1)
        f = self.temporal_ffn
        h = f["c_proj"](quick_gelu(f["c_fc2"](f["c_fc1"](h))))
        h = h.squeeze(-1).permute(0, 2, 3, 1).reshape(bt, l, c)
        return ffn_out + h


class Temporal2Integration(nn.Module):
    """Dense -> sparse: a stride-alpha temporal conv maps the dense stream
    onto the sparse frames' tokens, with a learned cls token prepended."""

    def __init__(self, cfg):
        super().__init__()
        a, c = cfg.alpha, cfg.integration_dim
        self.linear_fuse = Conv3d(cfg.temporal_dim, c, (a, 1, 1),
                                  stride=(a, 1, 1))
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.sparse_frames, c))

    def init_own(self, generator):
        _trunc_normal_(self.cls_token, 0.02, generator)

    def forward(self, x_temporal):
        x = _to_channels_last(self.linear_fuse(_to_channels_first(x_temporal)))
        b, t, hh, ww, c = x.shape
        x = x.reshape(b, t, hh * ww, c)
        cls = self.cls_token.to(x.dtype).reshape(1, t, 1, c).expand(b, t, 1, c)
        return torch.cat([cls, x], dim=2).reshape(b * t, 1 + hh * ww, c)


class Integration2Temporal(nn.Module):
    """Sparse -> dense: drop cls, project to the temporal dim,
    nearest-upsample the frame axis by alpha."""

    def __init__(self, cfg):
        super().__init__()
        self.t, self.alpha = cfg.sparse_frames, cfg.alpha
        self.linear_fuse = Linear(cfg.integration_dim, cfg.temporal_dim)

    def forward(self, mid_feat):
        x = self.linear_fuse(mid_feat[:, 1:, :])
        bt, l, c = x.shape
        hw = int(round(l ** 0.5))
        x = x.reshape(bt // self.t, self.t, hw, hw, c)
        return x.repeat_interleave(self.alpha, dim=1)


class StackedInputLinear(nn.ModuleList):
    """The per-layer tap projections ``input_linears.<i>`` (d_model -> C),
    applied as one batched product over the stacked taps."""

    def __init__(self, n, d_model, features):
        super().__init__(Linear(d_model, features) for _ in range(n))

    def forward(self, taps):
        n, bt, l, d = taps.shape
        dtype = taps.dtype
        w = torch.stack([m.weight for m in self]).to(dtype)   # (n, C, d)
        b = torch.stack([m.bias for m in self]).to(dtype)     # (n, C)
        y = torch.bmm(taps.reshape(n, bt * l, d), w.transpose(1, 2))
        return y.reshape(n, bt, l, -1) + b[:, None, None, :]


class AdaPooling(nn.Module):
    """Spatial-then-temporal cross-attention pooling."""

    def __init__(self, cfg):
        super().__init__()
        c = cfg.integration_dim
        heads = c // 64
        self.t = cfg.sparse_frames
        self.spatial_transformer = CrossAttentionBlock(c, heads)
        self.ln_out_spat_cls_token = LayerNorm(c)
        self.output_map_spatial_cls_token = MLP(c, 4 * c, c)
        self.positional_embedding = nn.Parameter(torch.empty(1, self.t, c))
        self.temporal_transformer = CrossAttentionBlock(c, heads)
        self.ln_out_temp_cls_token = LayerNorm(c)
        self.output_map_cls_token = MLP(c, 4 * c, c)

    def init_own(self, generator):
        _trunc_normal_(self.positional_embedding, 0.02, generator)

    def forward(self, prev_feat, top_cls, spatial_cls):
        # prev_feat (B*t, L, C); top_cls (B, 1, C); spatial_cls (B*t, 1, C)
        bt, _, c = prev_feat.shape
        b = bt // self.t
        spatial_cls = spatial_cls + self.spatial_transformer(spatial_cls,
                                                             prev_feat)
        spatial_cls = spatial_cls + self.output_map_spatial_cls_token(
            self.ln_out_spat_cls_token(spatial_cls))
        cls_tok = spatial_cls[:, 0, :].reshape(b, self.t, c)
        cls_tok = cls_tok + self.positional_embedding.to(cls_tok.dtype)
        top_cls = top_cls + self.temporal_transformer(top_cls, cls_tok)
        top_cls = top_cls + self.output_map_cls_token(
            self.ln_out_temp_cls_token(top_cls))
        return top_cls, spatial_cls


class DiSTNetwork(nn.Module):
    """The full side network.

    ``remat`` (``TPU.REMAT``, the JAX package's ``nn.remat`` of the ladder
    step): under grad, each ladder step keeps only its inputs and runs its
    forward again in the backward (``torch.utils.checkpoint``), so the
    ladder's activations live one step at a time; the values and gradients
    are those without it. A fused TemporalNet then launches its forward
    kernel twice a step. Under ``no_grad`` it changes nothing."""

    # the ladder the JAX package runs under nn.scan (its stacked outputs
    # are never dumped as feature maps)
    jax_scanned = ("temporal_nets", "integration2temporal_nets",
                   "temporal2integration_nets", "integration_nets")

    def __init__(self, cfg, d_model, output_dim, fused_temporal=False,
                 remat=False):
        super().__init__()
        n = len(cfg.selected_layers)
        c = cfg.integration_dim
        self.cfg = cfg
        self.d_model = d_model
        self.remat = remat
        self.temporal_stem = TemporalPatchStem(
            cfg.temporal_dim, cfg.t_patch_size, cfg.s_patch_size)
        self.input_linears = StackedInputLinear(n, d_model, c)
        self.temporal_nets = nn.ModuleList(
            TemporalNet(cfg, fused=fused_temporal) for _ in range(n))
        self.integration2temporal_nets = nn.ModuleList(
            Integration2Temporal(cfg) for _ in range(n))
        self.temporal2integration_nets = nn.ModuleList(
            Temporal2Integration(cfg) for _ in range(n))
        self.integration_nets = nn.ModuleList(
            IntegrationNetwork(cfg) for _ in range(n))
        self.adapooling_nets = nn.ModuleList(
            AdaPooling(cfg) for _ in range(cfg.ada_pooling_layers))
        self.aggregated_cls_token = nn.Parameter(torch.empty(1, 1, c))
        self.aggregated_spatial_cls_token = nn.Parameter(torch.empty(1, 1, c))
        self.proj_spatial_cls_token = Linear(d_model, c)
        self.ln_post = LayerNorm(c)
        self.proj = nn.Parameter(torch.empty(c, output_dim))

    def init_own(self, generator):
        _trunc_normal_(self.aggregated_cls_token, 0.02, generator)
        _trunc_normal_(self.aggregated_spatial_cls_token, 0.02, generator)
        self.proj.normal_(0.0, self.cfg.integration_dim ** -0.5,
                          generator=generator)

    def _ladder_step(self, i, x_temporal, res_feat, tap_mid):
        """One ladder iteration; ``tap_mid`` is the projected CLIP tap."""
        x_temporal = self.temporal_nets[i](x_temporal)
        mid = tap_mid + res_feat
        upd_temporal = self.integration2temporal_nets[i](mid) + x_temporal
        upd_mid = mid + self.temporal2integration_nets[i](x_temporal)
        res_feat = self.integration_nets[i](upd_mid)
        return upd_temporal, res_feat, upd_mid

    def forward(self, video, taps_selected):
        """video (B, T, H, W, 3); taps_selected (n, B*t, L, d_model)."""
        c = self.cfg.integration_dim
        t = self.cfg.sparse_frames
        bt = taps_selected.shape[1]
        b = bt // t
        dtype = taps_selected.dtype

        x_temporal = self.temporal_stem(video.to(dtype)).contiguous()
        taps_mid = self.input_linears(taps_selected)
        res_feat = torch.zeros_like(taps_mid[0])
        upd_mid = res_feat
        step = self._ladder_step
        if self.remat and torch.is_grad_enabled():
            step = functools.partial(checkpoint, step, use_reentrant=False)
        # unbind, not taps_mid[i]: the backward stacks the steps' gradients
        # once, where each select's backward would fill a zero tensor of
        # taps_mid's whole size and add it
        for i, tap_mid in enumerate(taps_mid.unbind(0)):
            x_temporal, res_feat, upd_mid = step(i, x_temporal, res_feat,
                                                 tap_mid)
        current_feat = res_feat + upd_mid

        top_cls = self.aggregated_cls_token.to(dtype).expand(b, 1, c)
        spatial_cls = self.aggregated_spatial_cls_token.to(dtype).expand(
            bt, 1, c)
        for pool in self.adapooling_nets:
            top_cls, spatial_cls = pool(current_feat, top_cls, spatial_cls)

        # pooled cls + mean over sparse frames of the last selected layer's cls
        last_cls = taps_selected[-1][:, 0, :].reshape(b, t, self.d_model)
        spatial_mean = self.proj_spatial_cls_token(last_cls.mean(dim=1))
        x_logits = self.ln_post(top_cls[:, 0, :] + spatial_mean)
        return x_logits @ self.proj.to(x_logits.dtype)
