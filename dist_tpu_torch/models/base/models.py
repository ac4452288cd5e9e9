"""Model registries, the heads and the model builder (port of
``dist_tpu/models/base/models.py``).

:func:`build_model` returns a :class:`VideoModel` with the ``preds,
logits = model.apply(inputs)`` contract of the task loops. Its
``module`` is what the optimizer, DDP, the EMA copy and the checkpoints
see, with the reference's key names: the CLIP(+DiST) model, whose head
(:class:`ClipVideoTextIdentity`) has no weights and stays beside it, or
a :class:`BaseVideoModel` whose children are the ``backbone`` and the
``head``. Weights are made from a seeded CPU ``torch.Generator`` and then
moved to the device, so the same seed gives the same weights on the CPU
and on the card.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

import torch.nn.functional as F

from dist_tpu_torch.models.base.blocks import init_weights
from dist_tpu_torch.models.base.bn import set_train_mode
from dist_tpu_torch.models.precision import island_dtype
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.registry import Registry

BACKBONE_REGISTRY = Registry("Backbone")
HEAD_REGISTRY = Registry("Head")
STEM_REGISTRY = Registry("Stem")
BRANCH_REGISTRY = Registry("Branch")

_NOT_PORTED = ("is not ported yet: the PyTorch port builds the CLIP+DiST, "
               "ResNet3D, SlowFast, S3D-G, video-transformer and ConvNeXt "
               "families (ROADMAP.md queue A: SSL/HiCo pretraining for the "
               "contrastive heads, TAL for the localization backbone and "
               "BMNHead, What no shipped config reaches for "
               "ClipVideoHeadLinear)")


def _eval_activation(out, activation):
    """A head's eval-mode output: softmax or sigmoid in fp32, else as is."""
    if activation == "softmax":
        return torch.softmax(out.to(island_dtype(out)), dim=-1)
    if activation == "sigmoid":
        return torch.sigmoid(out.to(island_dtype(out)))
    return out


def _pooled(x):
    """A head's input pooled: a dict's ``features`` (or ``vid_logits``); a
    5-D map ``(B, C, T, H, W)`` its mean over T, H and W in fp32."""
    if isinstance(x, dict):
        x = x.get("features", x.get("vid_logits"))
    if x.dim() == 5:
        x = x.mean(dim=(2, 3, 4), dtype=island_dtype(x))
    return x


@HEAD_REGISTRY.register()
class BaseHead(nn.Module):
    """The default classification head: the feature map's mean over T, H
    and W in fp32, dropout, the linear layer ``out``, and softmax (or
    sigmoid) in fp32 in eval mode. Returns ``(preds, pooled features)``."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 activation="softmax"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.out = nn.Linear(dim_in, num_classes)

    def forward(self, x):
        x = _pooled(x)
        if x.dim() > 2:
            x = x.reshape(x.shape[0], -1).to(island_dtype(x))
        feat = x
        if self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, self.training)
        out = self.out(x)
        if not self.training:
            out = _eval_activation(out, self.activation)
        return out, feat


@HEAD_REGISTRY.register()
class BaseHeadx2(nn.Module):
    """The dual verb/noun head for EPIC-KITCHENS (the reference's
    base_blocks.py:438-506): the pooled feature (a 5-D map's mean in
    fp32), dropout, the linear layers ``out1`` and ``out2``, softmax (or
    sigmoid) in fp32 in eval mode. Returns ``({"verb_class",
    "noun_class"}, pooled features)``."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 activation="softmax"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.out1 = nn.Linear(dim_in, num_classes[0])
        self.out2 = nn.Linear(dim_in, num_classes[1])

    def forward(self, x):
        feat = x = _pooled(x)
        if self.dropout_rate > 0:
            x = F.dropout(x, self.dropout_rate, self.training)
        outs = {}
        for key, linear in (("verb_class", self.out1),
                            ("noun_class", self.out2)):
            o = linear(x)
            outs[key] = o if self.training else _eval_activation(
                o, self.activation)
        return outs, feat


class BaseVideoModel(nn.Module):
    """``backbone`` then ``head`` (the reference's ``BaseVideoModel``):
    ``forward(video) -> (preds, logits)``; the head's output depends on
    the module's train or eval mode."""

    def __init__(self, backbone, head):
        super().__init__()
        self.backbone = backbone
        self.head = head

    def forward(self, video, text_features=None):
        return self.head(self.backbone(video))


@HEAD_REGISTRY.register()
class ClipVideoTextIdentity(nn.Module):
    """DiST's head: mean over the view axis of logits_per_image; softmax
    (or sigmoid) in fp32 at eval."""

    def __init__(self, activation="softmax"):
        super().__init__()
        self.activation = activation

    def forward(self, x, train=True):
        out = x["logits_per_image"] if isinstance(x, dict) else x
        out = out.mean(dim=1)
        if not train:
            out = _eval_activation(out, self.activation)
        return out, x


@dataclasses.dataclass
class VideoModel:
    """A built model: the module, the weightless head beside it (None
    when the head is inside the module) and the config; in a
    data-parallel run also ``ddp``, the module wrapped by
    ``DistributedDataParallel`` (``parallel/mesh.py::wrap_ddp``)."""

    module: nn.Module
    head: Optional[nn.Module]
    cfg: Any
    ddp: Optional[nn.Module] = None

    @property
    def device(self):
        return next(self.module.parameters()).device

    @property
    def is_text_model(self):
        """Whether the model classifies against label-text features."""
        return hasattr(self.module, "encode_text")

    def set_mode(self, train):
        """The module in train or eval mode; in train mode under
        ``BN.FREEZE`` its BatchNorm modules stay in eval mode."""
        frozen = bool(self.cfg.BN.get("FREEZE", False)) if self.cfg else False
        set_train_mode(self.module, train, frozen)

    def apply(self, inputs, train=False, state_dict=None):
        """``preds, logits`` for ``inputs = {"video", "text_features"}``,
        with the module in train or eval mode (:meth:`set_mode`);
        ``train=True`` gives the head's training output (no softmax).
        ``state_dict`` (e.g. an EMA copy, running stats included) stands
        in for the module's own weights and buffers in this call. The
        training forward goes through ``ddp`` where there is one, so that
        its backward all-reduces the gradients."""
        self.set_mode(train)
        args = (inputs["video"], inputs.get("text_features"))
        if state_dict is None:
            out = (self.ddp if train and self.ddp is not None
                   else self.module)(*args)
        else:
            out = torch.func.functional_call(self.module, state_dict, args)
        if isinstance(self.module, BaseVideoModel):
            return out
        if self.head is None:
            return out, out
        return self.head(out, train=train)

    def encode_text(self, tokens):
        return self.module.encode_text(tokens)


def build_head(cfg, dim_in=None):
    """The configured head: ``ClipVideoTextIdentity`` (no weights),
    ``BaseHead``, ``BaseHeadx2``, ``TransformerHead`` (``PRE_LOGITS``)
    or ``TransformerHeadx2`` over ``dim_in`` features (default the
    backbone's last ``NUM_FILTERS``, else its ``NUM_FEATURES``), or a
    head built from ``cfg`` (the SlowFast heads)."""
    name = cfg.VIDEO.HEAD.NAME
    if not name:
        return None
    _register_backbones()
    cls = HEAD_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(f"head {name!r} {_NOT_PORTED}")
    if cls is ClipVideoTextIdentity:
        return cls(activation=cfg.VIDEO.HEAD.ACTIVATION)
    head = cfg.VIDEO.HEAD
    common = (float(head.DROPOUT_RATE or 0.0), head.ACTIVATION)
    bb = cfg.VIDEO.BACKBONE
    dim_in = int(dim_in or (bb.NUM_FILTERS[-1] if bb.NUM_FILTERS
                            else bb.NUM_FEATURES))
    if name in ("BaseHeadx2", "TransformerHeadx2"):
        return cls(dim_in, tuple(int(n) for n in head.NUM_CLASSES), *common)
    if cls is BaseHead:
        return cls(dim_in, int(head.NUM_CLASSES or 0), *common)
    if name == "TransformerHead":
        return cls(dim_in, int(head.NUM_CLASSES or 0), *common,
                   pre_logits=bool(head.get("PRE_LOGITS", False)))
    return cls(cfg)


def _register_backbones():
    import dist_tpu_torch.models.backbones.resnet3d  # noqa: F401
    import dist_tpu_torch.models.backbones.s3dg  # noqa: F401
    import dist_tpu_torch.models.backbones.slowfast  # noqa: F401
    import dist_tpu_torch.models.backbones.video_transformer  # noqa: F401
    import dist_tpu_torch.models.backbones.vit_video  # noqa: F401
    import dist_tpu_torch.models.branches.tada_convnext  # noqa: F401
    import dist_tpu_torch.models.heads.transformer_head  # noqa: F401


def build_backbone_on_meta(cfg) -> nn.Module:
    """The configured module on the meta device: its parameter names and
    shapes, with no storage behind them. For a head with weights it is
    the :class:`BaseVideoModel` of backbone and head."""
    _register_backbones()
    meta_arch = cfg.VIDEO.BACKBONE.META_ARCH
    builder = BACKBONE_REGISTRY.get(meta_arch)
    if builder is None:
        raise NotImplementedError(f"meta-arch {meta_arch!r} {_NOT_PORTED}")
    with torch.device("meta"):
        backbone = builder(cfg)
        head = build_head(cfg, getattr(backbone, "out_dim", None))
        if head is not None and next(head.parameters(), None) is not None:
            return BaseVideoModel(backbone, head)
    return backbone


def build_model(cfg, device=None, seed=None) -> VideoModel:
    """Backbone + head, with random weights from ``seed`` (default
    ``cfg.RANDOM_SEED``), in eval mode on ``device`` (default: the CUDA
    card; raises without one unless ``device="cpu"``)."""
    device = resolve_device(device)
    module = build_backbone_on_meta(cfg).to_empty(device="cpu")
    gen = torch.Generator().manual_seed(
        int(cfg.RANDOM_SEED if seed is None else seed))
    init_weights(module, gen)
    module = module.to(device).eval()
    head = None if isinstance(module, BaseVideoModel) else build_head(cfg)
    return VideoModel(module=module, head=head, cfg=cfg)


@BACKBONE_REGISTRY.register(name="ClipVisionTextTransformer")
def _build_clip_vision_text(cfg):
    """Meta-arch for CLIP(+DiST) models."""
    from dist_tpu_torch.models.clip.clip_video import clip_dist_from_cfg
    return clip_dist_from_cfg(cfg)
