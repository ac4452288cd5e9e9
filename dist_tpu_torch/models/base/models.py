"""Model registries, the DiST head and the model builder (port of the
CLIP part of ``dist_tpu/models/base/models.py``).

:func:`build_model` returns a :class:`VideoModel`: the backbone
``nn.Module`` (whose state dict has the reference's key names) and the
head, with the ``preds, logits = model.apply(inputs)`` contract of the
task loops. Weights are made from a seeded CPU ``torch.Generator`` and
then moved to the device, so the same seed gives the same weights on the
CPU and on the card.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

from dist_tpu_torch.models.base.blocks import init_weights
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.registry import Registry

BACKBONE_REGISTRY = Registry("Backbone")
HEAD_REGISTRY = Registry("Head")

_NOT_PORTED = ("is not ported yet: the PyTorch port serves the CLIP+DiST "
               "path only (ROADMAP.md queue A, item 5: other backbones "
               "and heads)")


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
            if self.activation == "softmax":
                out = torch.softmax(out.float(), dim=-1)
            elif self.activation == "sigmoid":
                out = torch.sigmoid(out.float())
        return out, x


@dataclasses.dataclass
class VideoModel:
    """A built model: the backbone module, its head and the config; in a
    data-parallel run also ``ddp``, the module wrapped by
    ``DistributedDataParallel`` (``parallel/mesh.py::wrap_ddp``)."""

    module: nn.Module
    head: Optional[nn.Module]
    cfg: Any
    ddp: Optional[nn.Module] = None

    @property
    def device(self):
        return next(self.module.parameters()).device

    def apply(self, inputs, train=False, state_dict=None):
        """``preds, logits`` for ``inputs = {"video", "text_features"}``;
        ``train=True`` gives the head's training output (no softmax).
        ``state_dict`` (e.g. an EMA copy) stands in for the module's own
        weights in this call. The training forward goes through ``ddp``
        where there is one, so that its backward all-reduces the
        gradients."""
        args = (inputs["video"], inputs.get("text_features"))
        if state_dict is None:
            out = (self.ddp if train and self.ddp is not None
                   else self.module)(*args)
        else:
            out = torch.func.functional_call(self.module, state_dict, args)
        if self.head is None:
            return out, out
        return self.head(out, train=train)

    def encode_text(self, tokens):
        return self.module.encode_text(tokens)


def build_head(cfg):
    name = cfg.VIDEO.HEAD.NAME
    if not name:
        return None
    cls = HEAD_REGISTRY.get(name)
    if cls is None:
        raise NotImplementedError(f"head {name!r} {_NOT_PORTED}")
    return cls(activation=cfg.VIDEO.HEAD.ACTIVATION)


def build_backbone_on_meta(cfg) -> nn.Module:
    """The configured backbone on the meta device: its parameter names
    and shapes, with no storage behind them."""
    meta_arch = cfg.VIDEO.BACKBONE.META_ARCH
    builder = BACKBONE_REGISTRY.get(meta_arch)
    if builder is None:
        raise NotImplementedError(f"meta-arch {meta_arch!r} {_NOT_PORTED}")
    with torch.device("meta"):
        return builder(cfg)


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
    return VideoModel(module=module, head=build_head(cfg), cfg=cfg)


@BACKBONE_REGISTRY.register(name="ClipVisionTextTransformer")
def _build_clip_vision_text(cfg):
    """Meta-arch for CLIP(+DiST) models."""
    from dist_tpu_torch.models.clip.clip_video import clip_dist_from_cfg
    return clip_dist_from_cfg(cfg)
