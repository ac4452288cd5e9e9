"""TAda-ConvNeXt blocks and the ConvNeXt video meta-arch (port of
``dist_tpu/models/branches/tada_convnext.py``).

Activations are channels-last ``(B, T, H, W, C)`` as in the JAX package:
the LayerNorms and the pointwise layers act on the last axis, and each
convolution sees the same memory as cuDNN's channels-last NCDHW (a
permute, no copy). The block is a temporally-adaptive depthwise 1x7x7
conv whose calibration scales its output channels (a post-scale of the
conv's output, the bias calibrated on its own), an optional temporal
average pool through its own LayerNorm, then the ConvNeXt MLP with layer
scale and stochastic depth. :class:`ConvNeXt` returns the map ``(B, C,
T, H, W)`` that ``BaseHead`` pools.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.backbones.video_transformer import (
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    drop_rates,
    gelu,
)
from dist_tpu_torch.models.base.blocks import Conv3d
from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import BACKBONE_REGISTRY, BRANCH_REGISTRY
from dist_tpu_torch.models.branches.tada import ZeroConv3d
from dist_tpu_torch.models.precision import island_dtype, maybe_bf16_input


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x):
    return x.permute(0, 2, 3, 4, 1)


class RouteFuncNeXt(nn.Module):
    """The calibration generator, in fp32 whatever the activation dtype
    (float64 for float64): frame means plus ``g`` of the clip mean, the
    temporal conv ``a``, then BatchNorm (flax's, momentum 0.99) and ReLU
    (``normal``) or LayerNorm and the exact GELU (``normal_lngelu``), and
    the zero-init temporal convs ``b`` (and ``b_bias``) plus 1. ``(B, T,
    H, W, C)`` -> ``w_cal`` (and ``b_cal``) ``(B, T, 1, 1, C)``."""

    def __init__(self, c_in, ratio, kernels, route_type="normal",
                 with_bias_cal=False):
        super().__init__()
        k0, k1 = kernels
        mid = c_in // ratio
        self.route_type = route_type
        self.g = Conv(c_in, c_in, 1)
        self.a = Conv(c_in, mid, (k0, 1, 1), padding=(k0 // 2, 0, 0))
        if route_type == "normal":
            self.bn = BatchNorm(mid, momentum=0.99)
        else:
            self.ln = LayerNorm(mid, keep_dtype=False)
        self.b = ZeroConv3d(mid, c_in, (k1, 1, 1), padding=(k1 // 2, 0, 0),
                            bias=False)
        if with_bias_cal:
            self.b_bias = ZeroConv3d(mid, c_in, (k1, 1, 1),
                                     padding=(k1 // 2, 0, 0), bias=False)

    def forward(self, x):
        wide = island_dtype(x)
        frame = _ncdhw(x.mean(dim=(2, 3), keepdim=True, dtype=wide))
        glob = _ncdhw(x.mean(dim=(1, 2, 3), keepdim=True, dtype=wide))
        h = self.a(frame + self.g(glob))
        if self.route_type == "normal":
            h = F.relu(self.bn(h))
        else:
            h = _ncdhw(gelu(self.ln(_ndhwc(h))))
        w_cal = _ndhwc(self.b(h)) + 1.0
        if hasattr(self, "b_bias"):
            return w_cal, _ndhwc(self.b_bias(h)) + 1.0
        return w_cal


def _avg_pool_t(h):
    """flax's ``avg_pool`` over T, window 3, stride 1, zero padding 1
    counted in the divisor, on ``(B, T, H, W, C)``: the window's sum and
    the division in ``h``'s dtype, as flax rounds them."""
    hp = F.pad(h, (0, 0, 0, 0, 0, 0, 1, 1))
    t = h.shape[1]
    return (hp[:, :t] + hp[:, 1:t + 1] + hp[:, 2:t + 2]) / 3


class _TAdaConvNeXtBlockBase(nn.Module):
    """``inp + drop_path(gamma * pwconv2(gelu(pwconv1(normed))))`` with
    ``normed = norm(h)`` (+ ``avgpool_norm(avg-pool over T of h)``) and
    ``h = dwconv(inp) * w_cal + dwconv_bias * b_cal``."""

    with_avgpool = True
    avgpool_norm_scale = 0.0      # the pooled branch fades in from 0

    def __init__(self, dim, cfg, drop_path_rate=0.0, layer_scale_init=1e-6):
        super().__init__()
        br = cfg.VIDEO.BACKBONE.BRANCH
        self.dwconv_rf = RouteFuncNeXt(
            dim, int(br.get("ROUTE_FUNC_R", 4)),
            tuple(br.get("ROUTE_FUNC_K", [3, 3])),
            route_type=br.get("ROUTE_FUNC_TYPE", "normal"),
            with_bias_cal=True)
        self.dwconv = Conv3d(dim, dim, (1, 7, 7), padding=(0, 3, 3),
                             groups=dim, bias=False)
        self.dwconv_bias = nn.Parameter(torch.empty(dim))
        self.norm = LayerNorm(dim)
        if self.with_avgpool:
            self.avgpool_norm = LayerNorm(dim,
                                          scale_init=self.avgpool_norm_scale)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.layer_scale_init = float(layer_scale_init)
        if self.layer_scale_init > 0:
            self.gamma = nn.Parameter(torch.empty(dim))
        self.drop_path = DropPath(drop_path_rate)

    def init_own(self, generator):
        self.dwconv_bias.zero_()
        if self.layer_scale_init > 0:
            self.gamma.fill_(self.layer_scale_init)

    def forward(self, x):
        w_cal, b_cal = self.dwconv_rf(x)
        h = _ndhwc(self.dwconv(_ncdhw(x)))
        h = h * w_cal.to(h.dtype) + (self.dwconv_bias * b_cal).to(h.dtype)
        normed = self.norm(h)
        if self.with_avgpool:
            normed = normed + self.avgpool_norm(_avg_pool_t(h))
        h = self.pwconv2(gelu(self.pwconv1(normed)))
        if self.layer_scale_init > 0:
            h = self.gamma.to(h.dtype) * h
        return x + self.drop_path(h)


@BRANCH_REGISTRY.register()
class TAdaConvNeXtBlock(_TAdaConvNeXtBlockBase):
    """No average-pool branch."""

    with_avgpool = False


@BRANCH_REGISTRY.register()
class TAdaConvNeXtBlockAvgPoolGELU(_TAdaConvNeXtBlockBase):
    """The average-pool branch through a zero-init LayerNorm."""


@BRANCH_REGISTRY.register()
class TAdaConvNeXtBlockAvgPoolGELUOriginal(_TAdaConvNeXtBlockBase):
    """The average-pool branch through a LayerNorm at scale 1: it counts
    from the first step."""

    avgpool_norm_scale = 1.0


@BACKBONE_REGISTRY.register()
class ConvNeXt(nn.Module):
    """The 4-stage video ConvNeXt: ``stem_conv`` ``(T_KERNEL_SIZE, 4, 4)``
    at stride ``(1, 4, 4)`` (temporal padding ``tk // 2``), ``stem_norm``;
    each later stage ``down_norm{s}`` then ``down_conv{s}`` ``(1, 2, 2)``
    at stride ``(1, 2, 2)``; ``DEPTH[s]`` blocks ``stage{s}_block{i}`` of
    the configured branch (stochastic depth ``linspace(0, DROP_PATH,
    sum(DEPTH))``, layer scale ``LARGE_SCALE_INIT_VALUE``); the plain
    ``norm``. ``(B, T, H, W, 3)`` -> ``(B, C, T, H/32, W/32)``."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        self.depths = [int(d) for d in bb.DEPTH]
        dims = [int(d) for d in bb.NUM_FILTERS]
        self.out_dim = dims[-1]
        tk = int(bb.STEM.get("T_KERNEL_SIZE", 1) or 1)
        self.stem_conv = Conv(3, dims[0], (tk, 4, 4), (1, 4, 4),
                              padding=(tk // 2, 0, 0))
        self.stem_norm = LayerNorm(dims[0])
        branch_cls = BRANCH_REGISTRY.get_strict(bb.BRANCH.NAME)
        rates = iter(drop_rates(bb.get("DROP_PATH", 0.0), sum(self.depths)))
        scale = float(bb.get("LARGE_SCALE_INIT_VALUE", 1e-6))
        for stage, (depth, dim) in enumerate(zip(self.depths, dims)):
            if stage > 0:
                self.add_module(f"down_norm{stage}", LayerNorm(dims[stage - 1]))
                self.add_module(f"down_conv{stage}", Conv(
                    dims[stage - 1], dim, (1, 2, 2), (1, 2, 2)))
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", branch_cls(
                    dim=dim, cfg=cfg, drop_path_rate=next(rates),
                    layer_scale_init=scale))
        self.norm = LayerNorm(dims[-1], keep_dtype=False)

    def forward(self, x):
        if isinstance(x, dict):
            x = x["video"]
        x = maybe_bf16_input(self.cfg, x)
        x = self.stem_norm(_ndhwc(self.stem_conv(_ncdhw(x))))
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                x = getattr(self, f"down_norm{stage}")(x)
                x = _ndhwc(getattr(self, f"down_conv{stage}")(_ncdhw(x)))
            for i in range(depth):
                x = getattr(self, f"stage{stage}_block{i}")(x)
        return _ncdhw(self.norm(x))
