"""SlowFast networks (port of ``dist_tpu/models/backbones/slowfast.py``).

Two ResNet3D pathways, slow (T / ALPHA frames, wide) and fast (T frames,
width / BETA), with fast-to-slow lateral fusions (a stride-ALPHA temporal
conv) after the stem and each of the first three stages. The module takes
one dense clip ``(B, T, H, W, 3)`` and makes the slow clip itself as
every ALPHA-th frame. Activations are ``(B, C, T, H, W)``, so a fusion
concatenates onto axis 1. Parameter names are the JAX package's
(``slow_conv2.res_1_branch.a``, ``fusion1.conv_f2s``), with ConvBN's
``a``/``a_bn`` pairs of ``resnet3d.py``.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.backbones.resnet3d import (
    _N_CONV_RESNET,
    ConvBNSites,
    _Branch,
)
from dist_tpu_torch.models.base.blocks import Conv3d
from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import (
    BACKBONE_REGISTRY,
    BRANCH_REGISTRY,
    HEAD_REGISTRY,
    _eval_activation,
)
from dist_tpu_torch.models.precision import island_dtype, maybe_bf16_input


@BRANCH_REGISTRY.register()
class SlowfastBranch(_Branch):
    """Bottleneck with an optional temporal conv in ``a``
    (slowfast_branch.py:14-100). ``a`` is a fixed ``(3, 1, 1)`` when the
    stage's ``TEMPORAL_CONV_BOTTLENECK`` flag is set, whatever
    ``KERNEL_SIZE`` says (``[1, 3, 3]`` for those stages in the shipped
    configs): deriving it from the kernel would drop every temporal conv
    of the towers."""

    def __init__(self, spec):
        super().__init__()
        k, st = spec["kernel_size"], spec["stride"]
        din, nf = spec["dim_in"], spec["num_filters"]
        if spec["transformation"] == "simple_block":
            self.add("a", din, nf, k, st)
            self.add("b", nf, nf, k, relu=False)
            return
        exp = nf // spec["expansion_ratio"]
        kt = 3 if spec.get("temporal_conv_bottleneck", False) else 1
        self.add("a", din, exp, (kt, 1, 1))
        self.add("b", exp, exp, (1, k[1], k[2]), (1, st[1], st[2]))
        self.add("c", exp, nf, (1, 1, 1), relu=False)


class _PathwayCfg:
    """One pathway's view of the config (slowfast.py:37-50): the fast
    pathway divides the filters by ``BETA``; a slow stage's first block
    takes the fused fast channels too."""

    def __init__(self, cfg, pathway):
        self.cfg = cfg
        self.pathway = pathway      # 0 slow, 1 fast
        bb = cfg.VIDEO.BACKBONE
        self.beta = bb.SLOWFAST.BETA
        base = list(bb.NUM_FILTERS)
        self.filters = base if pathway == 0 else [f // self.beta for f in base]
        self.kernels = [tuple(k) for k in bb.KERNEL_SIZE[pathway]]
        self.tcb = list(bb.TEMPORAL_CONV_BOTTLENECK[pathway])

    def block_spec(self, stage_id, block_id):
        bb = self.cfg.VIDEO.BACKBONE
        dim_in = self.filters[stage_id - 1 if block_id == 0 else stage_id]
        if block_id == 0 and self.pathway == 0 and \
                bb.SLOWFAST.MODE == "slowfast":
            dim_in += (self.filters[stage_id - 1] // self.beta
                       * bb.SLOWFAST.CONV_CHANNEL_RATIO)
        down = bb.DOWNSAMPLING[stage_id] if block_id == 0 else False
        down_t = bb.DOWNSAMPLING_TEMPORAL[stage_id] if block_id == 0 else False
        stride = ((2, 2, 2) if down_t else (1, 2, 2)) if down else (1, 1, 1)
        return dict(dim_in=dim_in, num_filters=self.filters[stage_id],
                    kernel_size=self.kernels[stage_id], stride=stride,
                    transformation=("bottleneck" if bb.DEPTH > 34
                                    else "simple_block"),
                    expansion_ratio=bb.get("EXPANSION_RATIO", 4),
                    temporal_conv_bottleneck=self.tcb[stage_id],
                    branch_cfg=bb.BRANCH)


class _PathwayStage(ConvBNSites):
    """A res-stage of explicit block specs: block i is ``res_{i}_branch``
    plus the shortcut, a 1x1x1 ConvBN ``res_{i}_short_cut`` when the width
    or the stride changes."""

    def __init__(self, specs):
        super().__init__()
        self.num_blocks = len(specs)
        for i, spec in enumerate(specs, start=1):
            if (spec["dim_in"] != spec["num_filters"]
                    or spec["stride"] != (1, 1, 1)):
                self.add_conv_bn(f"res_{i}_short_cut", spec["dim_in"],
                                 spec["num_filters"], (1, 1, 1),
                                 spec["stride"], relu=False)
            self.add_module(f"res_{i}_branch", SlowfastBranch(spec))

    def forward(self, x):
        for i in range(1, self.num_blocks + 1):
            name = f"res_{i}_short_cut"
            shortcut = self.conv_bn(name, x) if name in self._relu else x
            x = F.relu(shortcut + getattr(self, f"res_{i}_branch")(x))
        return x


class FuseFastToSlow(nn.Module):
    """The lateral connection (slowfast.py:119-155): a ``(k, 1, 1)`` conv of
    stride ``ALPHA`` over the fast stream (bias under
    ``FUSION_CONV_BIAS``), BatchNorm in fp32 (flax's default momentum,
    0.99) and ReLU, concatenated onto the slow stream's channels."""

    def __init__(self, cfg, dim_in):
        super().__init__()
        sf = cfg.VIDEO.BACKBONE.SLOWFAST
        k = int(sf.KERNEL_SIZE)
        out = dim_in * int(sf.CONV_CHANNEL_RATIO)
        self.conv_f2s = Conv3d(dim_in, out, (k, 1, 1),
                               stride=(int(sf.ALPHA), 1, 1),
                               padding=(k // 2, 0, 0),
                               bias=bool(sf.get("FUSION_CONV_BIAS", False)))
        self.bn = (BatchNorm(out, momentum=0.99)
                   if sf.get("FUSION_BN", True) else None)
        self.relu = bool(sf.get("FUSION_RELU", True))

    def forward(self, x_slow, x_fast):
        fuse = self.conv_f2s(x_fast)
        if self.bn is not None:
            fuse = self.bn(fuse)
        if self.relu:
            fuse = F.relu(fuse)
        return torch.cat([x_slow, fuse], dim=1), x_fast


class _SlowFastStem(ConvBNSites):
    """A pathway's stem: ConvBN ``a`` of stride ``(1, 2, 2)``, then a ``(1,
    3, 3)`` max-pool of stride ``(1, 2, 2)`` (padded with -inf, as flax
    pads)."""

    def __init__(self, dim_in, kernel, filters):
        super().__init__()
        self.add_conv_bn("a", dim_in, filters, kernel, (1, 2, 2))

    def forward(self, x):
        return F.max_pool3d(self.conv_bn("a", x), (1, 3, 3), (1, 2, 2),
                            (0, 1, 1))


def _active(mode):
    """(slow pathway runs, fast pathway runs)."""
    return mode in ("slowfast", "slowonly"), mode in ("slowfast", "fastonly")


@BACKBONE_REGISTRY.register()
class Slowfast(nn.Module):
    """(slowfast.py:14-117). Input the dense clip ``(B, T, H, W, 3)``;
    output ``{"slow", "fast"}``, the
    two pathways' feature maps. ``SLOWFAST.MODE`` is ``slowfast``,
    ``slowonly`` or ``fastonly``; the fusions run in ``slowfast`` mode
    only, after the stem and stages 1-3."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        self.mode = bb.SLOWFAST.MODE
        self.alpha = int(bb.SLOWFAST.ALPHA)
        slow, fast = _PathwayCfg(cfg, 0), _PathwayCfg(cfg, 1)
        run_slow, run_fast = _active(self.mode)
        din = int(bb.get("NUM_INPUT_CHANNELS", 3) or 3)
        self.num_stages = len(_N_CONV_RESNET[bb.DEPTH])
        for prefix, pcfg, on in (("slow", slow, run_slow),
                                 ("fast", fast, run_fast)):
            if not on:
                continue
            self.add_module(f"{prefix}_conv1", _SlowFastStem(
                din, pcfg.kernels[0], pcfg.filters[0]))
            for stage_id, n in enumerate(_N_CONV_RESNET[bb.DEPTH], start=1):
                self.add_module(f"{prefix}_conv{stage_id + 1}", _PathwayStage(
                    [pcfg.block_spec(stage_id, i) for i in range(n)]))
        if self.mode == "slowfast":
            for stage_id in range(self.num_stages):
                self.add_module(f"fusion{stage_id + 1}",
                                FuseFastToSlow(cfg, fast.filters[stage_id]))
        self.out_dim = (slow.filters[-1] * run_slow
                        + fast.filters[-1] * run_fast)

    def forward(self, x):
        x_fast = maybe_bf16_input(self.cfg, x).permute(0, 4, 1, 2, 3)
        x_slow = x_fast[:, :, ::self.alpha]
        run_slow, run_fast = _active(self.mode)
        for stage in range(self.num_stages + 1):
            if run_slow:
                x_slow = getattr(self, f"slow_conv{stage + 1}")(x_slow)
            if run_fast:
                x_fast = getattr(self, f"fast_conv{stage + 1}")(x_fast)
            if self.mode == "slowfast" and stage < self.num_stages:
                x_slow, x_fast = getattr(self, f"fusion{stage + 1}")(
                    x_slow, x_fast)
        return {"slow": x_slow, "fast": x_fast}


def _pool_pathways(mode, x):
    """The pooled feature of both SlowFast heads (slowfast_head.py:80-95):
    each active pathway's mean over T, H and W in fp32, concatenated."""
    run_slow, run_fast = _active(mode)
    feats = []
    if run_slow:
        feats.append(x["slow"].mean(dim=(2, 3, 4),
                                    dtype=island_dtype(x["slow"])))
    if run_fast:
        feats.append(x["fast"].mean(dim=(2, 3, 4),
                                    dtype=island_dtype(x["fast"])))
    return torch.cat(feats, dim=-1)


class _SlowFastHeadBase(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        bb, head = cfg.VIDEO.BACKBONE, cfg.VIDEO.HEAD
        self.mode = bb.SLOWFAST.MODE
        run_slow, run_fast = _active(self.mode)
        width = int(bb.NUM_FILTERS[-1])
        self.dim_in = (width * run_slow
                       + width // int(bb.SLOWFAST.BETA) * run_fast)
        self.dropout_rate = float(head.DROPOUT_RATE or 0.0)
        self.activation = head.ACTIVATION

    def _features(self, x):
        feat = _pool_pathways(self.mode, x)
        h = feat
        if self.dropout_rate > 0:
            h = F.dropout(h, self.dropout_rate, self.training)
        return feat, h


@HEAD_REGISTRY.register()
class SlowFastHead(_SlowFastHeadBase):
    """The dual-pathway pooled head (slowfast_head.py:14-201): the pooled
    concat, dropout, ``out``, softmax in fp32 at eval. Returns ``(preds,
    pooled features)``."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.out = nn.Linear(self.dim_in, int(cfg.VIDEO.HEAD.NUM_CLASSES))

    def forward(self, x):
        feat, h = self._features(x)
        out = self.out(h)
        if not self.training and self.activation == "softmax":
            out = _eval_activation(out, "softmax")
        return out, feat


@HEAD_REGISTRY.register()
class SlowFastHeadx2(_SlowFastHeadBase):
    """The dual verb/noun SlowFast head for EPIC-KITCHENS
    (slowfast_head.py:106-201): the shared pooled feature, one linear per
    task (``out1``, ``out2``), softmax or sigmoid in fp32 at eval; the
    predictions are ``{"verb_class", "noun_class"}``."""

    def __init__(self, cfg):
        super().__init__(cfg)
        verbs, nouns = (int(n) for n in cfg.VIDEO.HEAD.NUM_CLASSES)
        self.out1 = nn.Linear(self.dim_in, verbs)
        self.out2 = nn.Linear(self.dim_in, nouns)

    def forward(self, x):
        feat, h = self._features(x)
        outs = {}
        for key, linear in (("verb_class", self.out1),
                            ("noun_class", self.out2)):
            o = linear(h)
            outs[key] = o if self.training else _eval_activation(
                o, self.activation)
        return outs, feat
