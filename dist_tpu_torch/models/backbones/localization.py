"""The TAL feature backbone (port of
``dist_tpu/models/backbones/localization.py``): a stack of 1-D
convolutions over precomputed per-snippet features."""

import torch.nn as nn
import torch.nn.functional as F

from dist_tpu_torch.models.base.models import BACKBONE_REGISTRY


@BACKBONE_REGISTRY.register()
class SimpleLocalizationConv(nn.Module):
    """Snippet features ``(B, T, C_feat)`` (or a dict's ``video``) ->
    ``(B, DIM1D, T)``: ``BACKBONE_LAYER`` layers ``conv{i}`` of kernel 3,
    padding 1, each followed by relu. A layer's groups are
    ``BACKBONE_GROUPS_NUM`` when its input channels divide by them, else
    1, as the JAX package's."""

    def __init__(self, cfg):
        super().__init__()
        dim = int(cfg.DATA.NUM_INPUT_CHANNELS)
        hidden = int(cfg.VIDEO.DIM1D)
        groups = int(cfg.VIDEO.get("BACKBONE_GROUPS_NUM", 1))
        self.layers = int(cfg.VIDEO.BACKBONE_LAYER)
        for i in range(self.layers):
            g = groups if dim % groups == 0 else 1
            setattr(self, f"conv{i}",
                    nn.Conv1d(dim, hidden, 3, padding=1, groups=g))
            dim = hidden
        self.out_dim = dim

    def forward(self, x):
        if isinstance(x, dict):
            x = x["video"]
        x = x.transpose(1, 2)
        for i in range(self.layers):
            conv = getattr(self, f"conv{i}")
            x = F.relu(F.conv1d(x, conv.weight.to(x.dtype),
                                conv.bias.to(x.dtype), padding=1,
                                groups=conv.groups))
        return x
