"""The I3D / S3D-G Inception backbone (port of
``dist_tpu/models/backbones/s3dg.py``).

The Inception-v1 channel plan with 3D convs; ``STConv3d`` factorises
each ``k x k x k`` conv into a spatial ``(1, k, k)`` and a temporal ``(k,
1, 1)`` conv (S3D), and ``SelfGating`` is S3D-G's feature gate.
Activations are ``(B, C, T, H, W)``; parameter names are the JAX
package's (``Mixed_3b.branch1_1.conv2``, ``...gating_b0.fc``), and every
BatchNorm has flax's default momentum, 0.99.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.blocks import Conv3d
from dist_tpu_torch.models.base.bn import BatchNorm
from dist_tpu_torch.models.base.models import (
    BACKBONE_REGISTRY,
    BRANCH_REGISTRY,
)
from dist_tpu_torch.models.precision import island_dtype, maybe_bf16_input


def _triple(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


class InceptionBaseConv3D(nn.Module):
    """conv, BatchNorm, ReLU (base_blocks.py:218-238); the conv is padded
    by half its kernel and has no bias."""

    def __init__(self, dim_in, features, kernel=1, stride=1):
        super().__init__()
        k = _triple(kernel)
        self.conv = Conv3d(dim_in, features, k, _triple(stride),
                           padding=tuple(kk // 2 for kk in k), bias=False)
        self.bn = BatchNorm(features, momentum=0.99)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


@BRANCH_REGISTRY.register()
class STConv3d(nn.Module):
    """The separable spatio-temporal conv (s3dg_branch.py:104-150):
    ``(1, k, k)`` of stride ``(1, s, s)``, BatchNorm, ReLU, then ``(k, 1,
    1)`` of stride ``(s, 1, 1)``, BatchNorm, ReLU."""

    def __init__(self, dim_in, features, kernel=3, stride=1):
        super().__init__()
        k, s = kernel, stride
        self.conv = Conv3d(dim_in, features, (1, k, k), (1, s, s),
                           padding=(0, k // 2, k // 2), bias=False)
        self.bn = BatchNorm(features, momentum=0.99)
        self.conv2 = Conv3d(features, features, (k, 1, 1), (s, 1, 1),
                            padding=(k // 2, 0, 0), bias=False)
        self.bn2 = BatchNorm(features, momentum=0.99)

    def forward(self, x):
        x = F.relu(self.bn(self.conv(x)))
        return F.relu(self.bn2(self.conv2(x)))


class SelfGating(nn.Module):
    """The S3D-G gate (s3dg_branch.py:92-102): the map's mean over T, H
    and W in fp32, ``fc``, a sigmoid; the gate is cast to the activation's
    type and scales each channel."""

    def __init__(self, dim):
        super().__init__()
        self.fc = nn.Linear(dim, dim)

    def forward(self, x):
        avg = x.mean(dim=(2, 3, 4), dtype=island_dtype(x))
        w = torch.sigmoid(self.fc(avg))
        return x * w[:, :, None, None, None].to(x.dtype)


class InceptionBlock3D(nn.Module):
    """The four-branch Inception block: a 1x1x1 conv; 1x1x1 then 3x3x3
    (``STConv3d`` or a full conv) twice over; a ``(3, 3, 3)`` max-pool of
    stride 1 padded by 1, then 1x1x1; each gated when ``gating``; the four
    concatenated on the channels."""

    def __init__(self, dim_in, out_planes, gating=True, use_st=True):
        super().__init__()
        o0, o1a, o1b, o2a, o2b, o3 = out_planes
        conv3 = STConv3d if use_st else InceptionBaseConv3D
        self.branch0 = InceptionBaseConv3D(dim_in, o0, 1)
        self.branch1_0 = InceptionBaseConv3D(dim_in, o1a, 1)
        self.branch1_1 = conv3(o1a, o1b, 3)
        self.branch2_0 = InceptionBaseConv3D(dim_in, o2a, 1)
        self.branch2_1 = conv3(o2a, o2b, 3)
        self.branch3_1 = InceptionBaseConv3D(dim_in, o3, 1)
        self.gating = gating
        if gating:
            for i, width in enumerate((o0, o1b, o2b, o3)):
                self.add_module(f"gating_b{i}", SelfGating(width))
        self.out_dim = o0 + o1b + o2b + o3

    def forward(self, x):
        b0 = self.branch0(x)
        b1 = self.branch1_1(self.branch1_0(x))
        b2 = self.branch2_1(self.branch2_0(x))
        b3 = self.branch3_1(F.max_pool3d(x, 3, 1, 1))
        branches = [b0, b1, b2, b3]
        if self.gating:
            branches = [getattr(self, f"gating_b{i}")(b)
                        for i, b in enumerate(branches)]
        return torch.cat(branches, dim=1)


# name: (input channels, [b0, b1a, b1b, b2a, b2b, b3])
_INCEPTION_PLAN = {
    "Mixed_3b": (192, [64, 96, 128, 16, 32, 32]),
    "Mixed_3c": (256, [128, 128, 192, 32, 96, 64]),
    "Mixed_4b": (480, [192, 96, 208, 16, 48, 64]),
    "Mixed_4c": (512, [160, 112, 224, 24, 64, 64]),
    "Mixed_4d": (512, [128, 128, 256, 24, 64, 64]),
    "Mixed_4e": (512, [112, 144, 288, 32, 64, 64]),
    "Mixed_4f": (528, [256, 160, 320, 32, 128, 128]),
    "Mixed_5b": (832, [256, 160, 320, 32, 128, 128]),
    "Mixed_5c": (832, [384, 192, 384, 48, 128, 128]),
}


@BACKBONE_REGISTRY.register()
class Inception3D(nn.Module):
    """S3D-G (``BRANCH.NAME: STConv3d``) or I3D (backbone.py:90-178).
    Input ``(B, T, H, W, 3)``; output the map ``(B, 1024, t, h, w)``,
    ``t = T / 8``, ``h = H / 32``. ``BRANCH.GATING`` (default on) gates
    every Inception branch."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.VIDEO.BACKBONE
        use_st = bb.BRANCH.NAME == "STConv3d"
        gating = bool(bb.BRANCH.get("GATING", True))
        conv3 = STConv3d if use_st else InceptionBaseConv3D
        din = int(bb.get("NUM_INPUT_CHANNELS", 3) or 3)
        self.Conv_1a = conv3(din, 64, 7, 2)
        self.Conv_2b = InceptionBaseConv3D(64, 64, 1)
        self.Conv_2c = conv3(64, 192, 3)
        for name, (dim_in, planes) in _INCEPTION_PLAN.items():
            self.add_module(name, InceptionBlock3D(dim_in, planes, gating,
                                                   use_st))
        self.out_dim = self.Mixed_5c.out_dim

    def forward(self, x):
        x = maybe_bf16_input(self.cfg, x).permute(0, 4, 1, 2, 3)
        x = self.Conv_1a(x)
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Conv_2c(self.Conv_2b(x))
        x = F.max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = F.max_pool3d(x, 3, 2, 1)
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e",
                     "Mixed_4f"):
            x = getattr(self, name)(x)
        # the (2, 2, 2) VALID pool is where a short clip's T (or a small
        # crop's H, W) reaches 0; torch refuses that pool, flax returns an
        # empty map and the JAX package's assertion fires after Mixed_5c:
        # the same assertion, on the shape the JAX package reports (NDHWC)
        b, _, t, h, w = x.shape
        out = (b, t // 2, h // 2, w // 2, self.out_dim)
        if not all(s > 0 for s in out):
            raise AssertionError(
                f"S3D-G collapsed a dimension to zero ({out}) — "
                f"the input clip is too short/small for the temporal/spatial "
                f"downsampling (needs >= 8 frames); a zero-sized pool yields "
                f"NaN features")
        x = F.max_pool3d(x, 2, 2)
        return self.Mixed_5c(self.Mixed_5b(x))
