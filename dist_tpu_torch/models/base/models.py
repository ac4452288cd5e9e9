"""Model registries, the heads and the model builder (port of
``dist_tpu/models/base/models.py``).

:func:`build_model` returns a :class:`VideoModel` with the ``preds,
logits = model.apply(inputs)`` contract of the task loops. Its
``module`` is what the optimizer, DDP, the EMA copy and the checkpoints
see, with the reference's key names: the CLIP(+DiST) model, whose head
(:class:`ClipVideoTextIdentity`) has no weights and stays beside it, or
whose head with weights (:class:`ClipVideoHeadLinear`) is its child
``head``, so that the CLIP names (``visual.*``, the text tower at the
root, ``logit_scale``) stay as they are; or a :class:`BaseVideoModel`
whose children are the ``backbone`` and the ``head``. Weights are made
from a seeded CPU ``torch.Generator`` and then moved to the device, so
the same seed gives the same weights on the CPU and on the card.
"""

import dataclasses
from typing import Any, Optional

import torch
import torch.nn as nn

import torch.nn.functional as F

from dist_tpu_torch.models.base.blocks import init_weights
from dist_tpu_torch.models.base.bn import set_train_mode
from dist_tpu_torch.models.precision import island_dtype
from dist_tpu_torch.parallel.fsdp import is_fsdp, reshard, swapped
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.registry import Registry

BACKBONE_REGISTRY = Registry("Backbone")
HEAD_REGISTRY = Registry("Head")
STEM_REGISTRY = Registry("Stem")
BRANCH_REGISTRY = Registry("Branch")

_NOT_PORTED = ("is not registered in the PyTorch port, which builds the "
               "CLIP+DiST, ResNet3D, SlowFast, S3D-G, video-transformer, "
               "ConvNeXt and localization families with their heads (the "
               "JAX package's registries)")


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


@HEAD_REGISTRY.register()
class ClipVideoHeadLinear(nn.Module):
    """The no-text CLIP head: a linear classifier over the video
    embedding. The mean of ``vid_logits`` over the view axis, dropout,
    the linear layer ``out`` (in fp32, or float64 for a float64 input, as
    flax promotes a bf16 input against fp32 weights), and a softmax in
    fp32 in eval mode. Returns ``(preds, the dropped-out feature)``, as
    the JAX head does."""

    def __init__(self, dim_in, num_classes, dropout_rate=0.0,
                 activation="softmax"):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = activation
        self.out = nn.Linear(dim_in, num_classes)

    def forward(self, x):
        feat = x["vid_logits"] if isinstance(x, dict) else x
        feat = feat.mean(dim=1)
        if self.dropout_rate > 0:
            feat = F.dropout(feat, self.dropout_rate, self.training)
        out = self.out(feat.to(island_dtype(feat)))
        if not self.training and self.activation == "softmax":
            out = torch.softmax(out, dim=-1)
        return out, feat


def _head_inside(module):
    """Whether ``module``'s forward returns the head's ``(preds,
    logits)``: a :class:`BaseVideoModel`, or a CLIP model with a head
    attached."""
    return (isinstance(module, BaseVideoModel)
            or isinstance(getattr(module, "head", None), nn.Module))


class _Capture:
    """The outputs one forward records, under the names the JAX package's
    ``capture_intermediates`` gives its modules: each module's dotted
    path from the capture's root, a child renamed by its parent's
    ``jax_names`` (``models/backbones/convert.py``), the root's output
    under ``__call__``. A subtree that the JAX package runs under
    ``nn.scan`` (a parent's ``jax_scanned``) records nothing, as its
    stacked 6-D outputs are never dumped. 5-D outputs are stored in the
    JAX layout ``(B, T, H, W, C)``: a module's ``(B, C, T, H, W)`` output
    is permuted, one whose ``channels_last_output`` is set is copied as
    it is. Each entry is the tuple of the module's calls' outputs."""

    def __init__(self, root, skip=()):
        self.records = {}
        self.paths = {root: "__call__"}

        def walk(mod, path):
            renames = getattr(mod, "jax_names", {})
            scanned = getattr(mod, "jax_scanned", ())
            for name, child in mod.named_children():
                if name in scanned or (mod is root and name in skip):
                    continue
                seg = renames.get(name, name).replace("/", ".")
                self.paths[child] = f"{path}.{seg}" if path else seg
                walk(child, self.paths[child])

        walk(root, "")

    def add(self, path, value, channels_last=False):
        self.records.setdefault(path, []).append(
            _jax_layout(value, channels_last))

    def hook(self, module, args, out):
        path = self.paths[module]
        last = bool(getattr(module, "channels_last_output", False))
        self.add(path, out, last)
        for alias in getattr(module, "jax_output_aliases", ()):
            self.add(f"{path}.{alias}", out, last)


def _jax_layout(value, channels_last):
    """A copy of ``value`` (a tensor, or tuples, lists and dicts of them)
    with each 5-D tensor in the JAX layout."""
    if isinstance(value, dict):
        return {k: _jax_layout(v, channels_last) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return tuple(_jax_layout(v, channels_last) for v in value)
    if torch.is_tensor(value):
        if value.dim() == 5 and not channels_last:
            value = value.permute(0, 2, 3, 4, 1)
        return value.detach().clone(memory_format=torch.contiguous_format)
    return value


_CAPTURE: Optional[_Capture] = None


def record_site(module, name, value):
    """Record ``value`` as the output of ``module``'s JAX submodule
    ``name``, a site that is no module of the port (a ConvBN site's
    output after its ReLU), while :meth:`VideoModel.
    forward_with_intermediates` runs; otherwise nothing."""
    if _CAPTURE is not None and module in _CAPTURE.paths:
        path = _CAPTURE.paths[module]
        _CAPTURE.add(name if path == "__call__" else f"{path}.{name}", value)


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
        in for the module's own weights and buffers in this call (under
        FSDP it is copied into the shards for the call). The
        training forward goes through ``ddp`` where there is one, so that
        its backward all-reduces the gradients."""
        self.set_mode(train)
        args = (inputs["video"], inputs.get("text_features"))
        if state_dict is None:
            out = (self.ddp if train and self.ddp is not None
                   else self.module)(*args)
        elif is_fsdp(self.module):
            with swapped(self.module, state_dict):
                out = self.module(*args)
        else:
            out = torch.func.functional_call(self.module, state_dict, args)
        if _head_inside(self.module):
            return out
        if self.head is None:
            return out, out
        return self.head(out, train=train)

    def forward_with_intermediates(self, video, text_features=None):
        """The eval forward with every submodule's output captured, the
        counterpart of the JAX package's ``apply_with_intermediates``:
        returns ``(preds, {name: outputs})``, the same predictions as
        :meth:`apply` in eval mode. Forward hooks on every module of the
        backbone (a ``BaseVideoModel``'s ``backbone``, else the module
        without its ``head``) record its outputs under its JAX name
        (:class:`_Capture`; a 6-D SSL batch is flattened first, and the
        head runs after, as in the JAX package); the hooks only read."""
        global _CAPTURE
        if video.dim() == 6:
            video = video.reshape((-1,) + tuple(video.shape[2:]))
        if isinstance(self.module, BaseVideoModel):
            capture = _Capture(self.module.backbone)
        else:
            capture = _Capture(self.module, skip=("head",))
            if _head_inside(self.module):
                # the root's output is the head's here: JAX's is the
                # backbone's, which holds no 5-D map for a CLIP model
                del capture.paths[self.module]
        handles = [m.register_forward_hook(capture.hook)
                   for m in capture.paths]
        previous, _CAPTURE = _CAPTURE, capture
        try:
            with torch.no_grad():
                preds, _ = self.apply({"video": video,
                                       "text_features": text_features},
                                      train=False)
        finally:
            _CAPTURE = previous
            for h in handles:
                h.remove()
        return preds, {k: tuple(v) for k, v in capture.records.items()}

    def encode_text(self, tokens):
        if is_fsdp(self.module):
            # through the module's call, whose hooks gather the weights;
            # the root's stay gathered after a forward until resharded
            feats = self.module(None, tokens=tokens)
            reshard(self.module)
            return feats
        return self.module.encode_text(tokens)


def build_head(cfg, dim_in=None):
    """The configured head: ``ClipVideoTextIdentity`` (no weights),
    ``ClipVideoHeadLinear``, ``BaseHead``, ``BaseHeadx2``,
    ``TransformerHead`` (``PRE_LOGITS``), ``TransformerHeadx2``, a
    contrastive head
    (``models/heads/contrastive.py``, from ``PRETRAIN.CONTRASTIVE``) or
    ``BMNHead`` (``models/heads/bmn.py``) over
    ``dim_in`` features (default the backbone's last ``NUM_FILTERS``,
    else its ``NUM_FEATURES``), or a head built from ``cfg`` (the
    SlowFast heads)."""
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
    if cls in (BaseHead, ClipVideoHeadLinear):
        return cls(dim_in, int(head.NUM_CLASSES or 0), *common)
    if name == "TransformerHead":
        return cls(dim_in, int(head.NUM_CLASSES or 0), *common,
                   pre_logits=bool(head.get("PRE_LOGITS", False)))
    if name.startswith("ContrastiveHead") or name == "BMNHead":
        return cls(cfg, dim_in)
    return cls(cfg)


def _register_backbones():
    import dist_tpu_torch.models.backbones.localization  # noqa: F401
    import dist_tpu_torch.models.backbones.resnet3d  # noqa: F401
    import dist_tpu_torch.models.backbones.s3dg  # noqa: F401
    import dist_tpu_torch.models.backbones.slowfast  # noqa: F401
    import dist_tpu_torch.models.backbones.video_transformer  # noqa: F401
    import dist_tpu_torch.models.backbones.vit_video  # noqa: F401
    import dist_tpu_torch.models.branches.tada_convnext  # noqa: F401
    import dist_tpu_torch.models.heads.bmn  # noqa: F401
    import dist_tpu_torch.models.heads.contrastive  # noqa: F401
    import dist_tpu_torch.models.heads.transformer_head  # noqa: F401


def build_backbone_on_meta(cfg) -> nn.Module:
    """The configured module on the meta device: its parameter names and
    shapes, with no storage behind them. For a head with weights it is
    the :class:`BaseVideoModel` of backbone and head, or, for a CLIP
    backbone (which has ``attach_head``), the backbone with the head as
    its child ``head`` over its embedding (``out_dim``)."""
    _register_backbones()
    meta_arch = cfg.VIDEO.BACKBONE.META_ARCH
    builder = BACKBONE_REGISTRY.get(meta_arch)
    if builder is None:
        raise NotImplementedError(f"meta-arch {meta_arch!r} {_NOT_PORTED}")
    with torch.device("meta"):
        backbone = builder(cfg)
        head = build_head(cfg, getattr(backbone, "out_dim", None))
        if head is not None and next(head.parameters(), None) is not None:
            if hasattr(backbone, "attach_head"):
                backbone.attach_head(head)
                return backbone
            return BaseVideoModel(backbone, head)
    return backbone


def build_model(cfg, device=None, seed=None) -> VideoModel:
    """Backbone + head, with random weights from ``seed`` (default
    ``cfg.RANDOM_SEED``), in eval mode on ``device`` (default: the CUDA
    card; raises without one unless ``device="cpu"``). ``TPU.MESH.PIPE``
    above 1 is taken by the CLIP meta-arch alone, as in the JAX
    package."""
    device = resolve_device(device)
    meta_arch = cfg.VIDEO.BACKBONE.META_ARCH
    pipe = int(((cfg.get("TPU") or {}).get("MESH") or {}).get("PIPE", 1) or 1)
    if pipe > 1 and meta_arch != "ClipVisionTextTransformer":
        raise ValueError(
            f"TPU.MESH.PIPE={pipe} is only wired into the CLIP tower "
            f"(parallel/pipeline.py); {meta_arch} would duplicate all work "
            "across the pipe axis -- use the data/model axes instead")
    module = build_backbone_on_meta(cfg).to_empty(device="cpu")
    gen = torch.Generator().manual_seed(
        int(cfg.RANDOM_SEED if seed is None else seed))
    init_weights(module, gen)
    module = module.to(device).eval()
    head = None if _head_inside(module) else build_head(cfg)
    return VideoModel(module=module, head=head, cfg=cfg)


@BACKBONE_REGISTRY.register(name="ClipVisionTextTransformer")
def _build_clip_vision_text(cfg):
    """Meta-arch for CLIP(+DiST) models."""
    from dist_tpu_torch.models.clip.clip_video import clip_dist_from_cfg
    return clip_dist_from_cfg(cfg)
