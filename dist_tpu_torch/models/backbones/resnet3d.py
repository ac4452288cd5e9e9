"""The 3D-ResNet meta-architecture and its stems and branches (port of
``dist_tpu/models/backbones/resnet3d.py``).

Activations are ``(B, C, T, H, W)``, cuDNN's NCDHW; clips arrive ``(B, T,
H, W, 3)`` and are permuted once, in :class:`ResNet3D`. Parameters keep
the reference's names: a ConvBN site ``a`` of the JAX package (children
``conv`` and ``bn``) is the pair ``a`` (the convolution) and ``a_bn``
here, a residual block's projection is ``short_cut``/``short_cut_bn``.
Each module's ``JAX_NAMES`` (or ``jax_names``) maps a child to its path
in the JAX package's tree, which ``models/backbones/convert.py`` follows.
"""

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

import dist_tpu_torch.models.branches.tada  # noqa: F401  (registers it)
from dist_tpu_torch.models.base.blocks import Conv3d
from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import (
    BACKBONE_REGISTRY,
    BRANCH_REGISTRY,
    STEM_REGISTRY,
    record_site,
)
from dist_tpu_torch.models.precision import island_dtype, maybe_bf16_input

_N_CONV_RESNET = {
    10: (1, 1, 1, 1),
    16: (2, 2, 2, 1),
    18: (2, 2, 2, 2),
    26: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


def block_shapes(cfg, stage_id, block_id):
    """Per-block (dim_in, num_filters, kernel, stride, transformation)
    (reference ``models/utils/params.py:6-64``)."""
    bb = cfg.VIDEO.BACKBONE
    if block_id == 0:
        dim_in = bb.NUM_FILTERS[stage_id - 1]
        downsampling = bb.DOWNSAMPLING[stage_id]
        downsampling_temporal = bb.DOWNSAMPLING_TEMPORAL[stage_id]
    else:
        dim_in = bb.NUM_FILTERS[stage_id]
        downsampling = False
        downsampling_temporal = False
    num_filters = bb.NUM_FILTERS[stage_id]
    kernel_size = tuple(bb.KERNEL_SIZE[stage_id])
    if downsampling:
        stride = (2, 2, 2) if downsampling_temporal else (1, 2, 2)
    else:
        stride = (1, 1, 1)
    depth = bb.DEPTH
    transformation = ("bottleneck" if isinstance(depth, str) or depth > 34
                      else "simple_block")
    return dict(dim_in=dim_in, num_filters=num_filters,
                kernel_size=kernel_size, stride=stride,
                transformation=transformation,
                expansion_ratio=bb.get("EXPANSION_RATIO", 2),
                branch_cfg=bb.BRANCH)


class HeConv3d(Conv3d):
    """ConvBN's convolution: He-normal init (flax's ``he_normal``, a
    normal truncated at two standard deviations)."""

    def init_own(self, generator):
        std = (2.0 / self.weight[0].numel()) ** 0.5 / .87962566103423978
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        if self.bias is not None:
            self.bias.zero_()


class ConvBNSites(nn.Module):
    """A module made of ConvBN sites: :meth:`add_conv_bn` registers the
    reference's pair ``name`` (conv, padded to keep the size) and
    ``name + "_bn"``; :meth:`conv_bn` runs conv, BN (momentum 0.9, eps
    1e-5) and the ReLU when the site has one. Without BN the conv has a
    bias."""

    def __init__(self):
        super().__init__()
        self.jax_names = {}
        self._relu = {}
        self._site = {}

    def add_conv_bn(self, name, dim_in, features, kernel, stride=(1, 1, 1),
                    relu=True, groups=1, use_bn=True, jax=None):
        setattr(self, name, HeConv3d(
            dim_in, features, tuple(kernel), tuple(stride),
            padding=tuple(k // 2 for k in kernel), groups=groups,
            bias=not use_bn))
        jax = jax or name
        self._site[name] = jax.replace("/", ".")
        self.jax_names[name] = f"{jax}/conv"
        if use_bn:
            setattr(self, name + "_bn", BatchNorm(features, momentum=0.9))
            self.jax_names[name + "_bn"] = f"{jax}/bn"
        self._relu[name] = relu

    def conv_bn(self, name, x):
        x = getattr(self, name)(x)
        bn = getattr(self, name + "_bn", None)
        if bn is not None:
            x = bn(x)
        x = F.relu(x) if self._relu[name] else x
        # the JAX package's ConvBN module's output
        record_site(self, self._site[name], x)
        return x


def _r2plus1d_mid(k, din, dout):
    """(2+1)D factorization mid-width (r2plus1d_branch.py:30-33)."""
    return int(math.floor((k[0] * k[1] * k[2] * din * dout)
                          / (k[1] * k[2] * din + k[0] * dout)))


class _Branch(ConvBNSites):
    """A residual branch: its ConvBN sites run in order."""

    def __init__(self):
        super().__init__()
        self.order = []

    def add(self, name, *args, **kwargs):
        self.add_conv_bn(name, *args, **kwargs)
        self.order.append(name)

    def forward(self, x):
        for name in self.order:
            x = self.conv_bn(name, x)
        return x


@BRANCH_REGISTRY.register()
class R2Plus1DBranch(_Branch):
    """(2+1)D factorized conv branch (r2plus1d_branch.py:14-158)."""

    def __init__(self, spec):
        super().__init__()
        k, st = spec["kernel_size"], spec["stride"]
        din, nf = spec["dim_in"], spec["num_filters"]
        if spec["transformation"] == "simple_block":
            mid = _r2plus1d_mid(k, din, nf)
            self.add("a1", din, mid, (1, k[1], k[2]), (1, st[1], st[2]))
            self.add("a2", mid, nf, (k[0], 1, 1), (st[0], 1, 1))
            mid = _r2plus1d_mid(k, nf, nf)
            self.add("b1", nf, mid, (1, k[1], k[2]))
            self.add("b2", mid, nf, (k[0], 1, 1), relu=False)
            return
        exp = nf // spec["expansion_ratio"]
        self.add("a", din, exp, (1, 1, 1))
        self.add("b1", exp, exp, (1, k[1], k[2]), (1, st[1], st[2]))
        self.add("b2", exp, exp, (k[0], 1, 1), (st[0], 1, 1))
        self.add("c", exp, nf, (1, 1, 1), relu=False)


@BRANCH_REGISTRY.register()
class R2D3DBranch(_Branch):
    """2D-in-3D branch at the configured kernel (r2d3d_branch.py:13-108)."""

    def __init__(self, spec):
        super().__init__()
        k, st = spec["kernel_size"], spec["stride"]
        din, nf = spec["dim_in"], spec["num_filters"]
        if spec["transformation"] == "simple_block":
            self.add("a", din, nf, k, st)
            self.add("b", nf, nf, k, relu=False)
            return
        exp = nf // spec["expansion_ratio"]
        self.add("a", din, exp, (1, 1, 1))
        self.add("b", exp, exp, k, st)
        self.add("c", exp, nf, (1, 1, 1), relu=False)


@BRANCH_REGISTRY.register()
class CSNBranch(_Branch):
    """Channel-separated bottleneck: depthwise k (csn_branch.py:13-74)."""

    def __init__(self, spec):
        super().__init__()
        k, st = spec["kernel_size"], spec["stride"]
        exp = spec["num_filters"] // spec["expansion_ratio"]
        self.add("a", spec["dim_in"], exp, (1, 1, 1))
        self.add("b", exp, exp, k, st, groups=exp)
        self.add("c", exp, spec["num_filters"], (1, 1, 1), relu=False)


@BRANCH_REGISTRY.register()
class SimpleBranch(_Branch):
    """Vanilla 3D conv branch (slowfast_branch.py:14-100 style)."""

    def __init__(self, spec):
        super().__init__()
        k, st = spec["kernel_size"], spec["stride"]
        din, nf = spec["dim_in"], spec["num_filters"]
        if spec["transformation"] == "simple_block":
            self.add("a", din, nf, k, st)
            self.add("b", nf, nf, k, relu=False)
            return
        exp = nf // spec["expansion_ratio"]
        self.add("a", din, exp, (k[0], 1, 1))
        self.add("b", exp, exp, (1, k[1], k[2]), (1, st[1], st[2]))
        self.add("c", exp, nf, (1, 1, 1), relu=False)


@BRANCH_REGISTRY.register()
class NonLocal(nn.Module):
    """Non-local block: embedded-gaussian attention over T*H*W
    (non_local.py:12-75). Its 1x1x1 convs have biases; the scores are
    fp32, scaled by ``inner ** -0.5``; the BN (flax's default momentum,
    0.99) starts at scale 0, so the block starts as the identity."""

    def __init__(self, dim):
        super().__init__()
        inner = dim // 2
        self.theta = Conv3d(dim, inner, 1)
        self.phi = Conv3d(dim, inner, 1)
        self.g = Conv3d(dim, inner, 1)
        self.out = Conv3d(inner, dim, 1)
        self.bn = BatchNorm(dim, momentum=0.99, zero_init=True)

    def forward(self, x):
        b, _, t, h, w = x.shape
        q = self.theta(x).flatten(2).transpose(1, 2)        # (B, N, inner)
        k = self.phi(x).flatten(2)                          # (B, inner, N)
        v = self.g(x).flatten(2).transpose(1, 2)            # (B, N, inner)
        wide = island_dtype(q)
        att = torch.bmm(q.to(wide), k.to(wide)) * (q.shape[-1] ** -0.5)
        att = torch.softmax(att, dim=-1)
        out = torch.bmm(att.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, -1, t, h, w)
        return x + self.bn(self.out(out))


class Base3DBlock(ConvBNSites):
    """Residual block: the shortcut (a 1x1x1 ConvBN when the shape or the
    stride changes) plus the registry's branch (base_blocks.py:103-152)."""

    def __init__(self, cfg, stage_id, block_id):
        super().__init__()
        spec = block_shapes(cfg, stage_id, block_id)
        branch_cls = BRANCH_REGISTRY.get_strict(cfg.VIDEO.BACKBONE.BRANCH.NAME)
        if (spec["dim_in"] != spec["num_filters"]
                or spec["stride"] != (1, 1, 1)):
            self.add_conv_bn("short_cut", spec["dim_in"], spec["num_filters"],
                             (1, 1, 1), spec["stride"], relu=False)
        self.conv_branch = branch_cls(spec)

    def forward(self, x):
        shortcut = (self.conv_bn("short_cut", x) if hasattr(self, "short_cut")
                    else x)
        return F.relu(shortcut + self.conv_branch(x))


class Base3DResStage(nn.Module):
    """``res_1`` ... ``res_n``, then ``nonlocal`` where configured
    (base_blocks.py:155-215)."""

    def __init__(self, cfg, num_blocks, stage_id):
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"res_{i + 1}", Base3DBlock(cfg, stage_id, i))
        nl = cfg.VIDEO.BACKBONE.NONLOCAL
        if nl.ENABLE and (stage_id + 1) in list(nl.STAGES):
            self.add_module("nonlocal",
                            NonLocal(cfg.VIDEO.BACKBONE.NUM_FILTERS[stage_id]))

    def forward(self, x):
        for i in range(self.num_blocks):
            x = getattr(self, f"res_{i + 1}")(x)
        nonlocal_block = getattr(self, "nonlocal", None)
        return x if nonlocal_block is None else nonlocal_block(x)


# ----------------------------- stems -----------------------------


def _stem_geometry(cfg):
    bb = cfg.VIDEO.BACKBONE
    k = tuple(bb.KERNEL_SIZE[0])
    down, down_t = bb.DOWNSAMPLING[0], bb.DOWNSAMPLING_TEMPORAL[0]
    stride = ((2, 2, 2) if down_t else (1, 2, 2)) if down else (1, 1, 1)
    return (int(bb.get("NUM_INPUT_CHANNELS", 3) or 3), bb.NUM_FILTERS[0], k,
            stride)


class _Stem(ConvBNSites):
    def forward(self, x):
        for name in self._relu:
            x = self.conv_bn(name, x)
        return x


@STEM_REGISTRY.register()
class Base2DStem(_Stem):
    """Spatial-only stem (base_blocks.py:240-300)."""

    def __init__(self, cfg):
        super().__init__()
        din, f, k, stride = _stem_geometry(cfg)
        down = cfg.VIDEO.BACKBONE.DOWNSAMPLING[0]
        self.add_conv_bn("a", din, f, (1, k[1], k[2]),
                         (1, 2, 2) if down else (1, 1, 1))


@STEM_REGISTRY.register()
class Base3DStem(_Stem):
    """(base_blocks.py:300-365)"""

    def __init__(self, cfg, jax=None):
        super().__init__()
        din, f, k, stride = _stem_geometry(cfg)
        self.add_conv_bn("a", din, f, k, stride, jax=jax)


@STEM_REGISTRY.register()
class DownSampleStem(Base3DStem):
    """Base3DStem, then a (1, 3, 3) max-pool of stride (1, 2, 2)
    (stems/downsample_stem.py:13-43); the JAX package nests the
    Base3DStem as ``stem``."""

    def __init__(self, cfg):
        super().__init__(cfg, jax="stem/a")

    def forward(self, x):
        return F.max_pool3d(super().forward(x), (1, 3, 3), (1, 2, 2),
                            (0, 1, 1))


@STEM_REGISTRY.register()
class R2Plus1DStem(_Stem):
    """(2+1)D stem (stems/r2plus1d_stem.py:14-68)."""

    def __init__(self, cfg):
        super().__init__()
        din, f, k, stride = _stem_geometry(cfg)
        mid = _r2plus1d_mid(k, din, f)
        self.add_conv_bn("a1", din, mid, (1, k[1], k[2]),
                         (1, stride[1], stride[2]))
        self.add_conv_bn("a2", mid, f, (k[0], 1, 1), (stride[0], 1, 1))


# ----------------------------- meta-arch -----------------------------


@BACKBONE_REGISTRY.register()
class ResNet3D(nn.Module):
    """(backbone.py:29-88). Input ``(B, T, H, W, C)``; output the feature
    map ``(B, C_out, t, h, w)``; ``conv1`` the stem, ``conv2`` ...
    ``conv5`` the res-stages."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        self.conv1 = STEM_REGISTRY.get_strict(bb.STEM.NAME)(cfg)
        for stage_id, n in enumerate(_N_CONV_RESNET[bb.DEPTH], start=1):
            self.add_module(f"conv{stage_id + 1}",
                            Base3DResStage(cfg, n, stage_id))

    def forward(self, x):
        # TRAIN.MIXED_PRECISION: one cast; every layer below follows the
        # activation dtype
        x = maybe_bf16_input(self.cfg, x)
        x = x.permute(0, 4, 1, 2, 3).contiguous()
        x = self.conv1(x)
        for stage in (self.conv2, self.conv3, self.conv4, self.conv5):
            x = stage(x)
        return x
