"""CLIP + DiST video model (port of ``dist_tpu/models/clip/clip_video.py``).

Label-text features are computed once by :meth:`CLIPDiSTModel.encode_text`
and passed into every forward, as in the JAX package. A frozen tower runs
under ``torch.no_grad()`` (the JAX package's ``stop_gradient``): nothing of
it enters the autograd graph and its attention launches the forward kernel
alone. An unfrozen tower (``FREEZE_VISUAL`` false, as the CLIP fine-tunes
ship) runs under autograd and trains through the attention kernel and its
backward kernel. Video is (B, T, H, W, 3) channels-last throughout.

The no-text CLIP fine-tune classifies the video embedding with
``ClipVideoHeadLinear``; that head, which has weights, is this module's
child ``head`` (``head.out.*``), so the reference's CLIP state dict still
loads with its own key names beside it.
"""

from typing import Optional

import torch
import torch.nn as nn

from dist_tpu_torch.models.clip.model import (
    ARCHITECTURES,
    CLIPArchitecture,
    TextTransformer,
    VisionTransformer,
)
from dist_tpu_torch.models.dist.dist_net import DiSTConfig, DiSTNetwork


def _normalize(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-6)


class CLIPDiSTModel(TextTransformer):
    """CLIP towers plus (optionally) the DiST side network.

    The text tower's parameters are this module's own (the root of the
    reference state dict); ``visual`` and ``dist_net`` are children.

    forward(video, text_features) -> dict with
      logits_per_image (B, 1, num_classes): cosine classifier over the
        label-text features, scaled by exp(logit_scale), with the view axis
        the head means over;
      vid_logits (B, 1, embed_dim); img_logits (B*t, embed_dim);
    or, with a head attached (:meth:`attach_head`), the head's ``(preds,
    logits)`` of that dict, in the module's train or eval mode.

    ``remat`` (``TPU.REMAT``) recomputes in the backward each block of a
    tower that trains and each ladder step.
    """

    def __init__(self, arch: CLIPArchitecture, dist: Optional[DiSTConfig] = None,
                 num_frames=16, sparse_alpha=1, freeze_visual=True,
                 freeze_text=True, prediction_fusion=False, fusion_weight=0.5,
                 dtype=torch.float32, fused_temporal=False, remat=False,
                 pipe_stages=1, pipe_microbatches=0):
        super().__init__(arch, remat=remat)
        self.dist = dist
        self.num_frames = num_frames
        self.sparse_alpha = sparse_alpha
        self.freeze_visual = freeze_visual
        self.freeze_text = freeze_text
        self.prediction_fusion = prediction_fusion
        self.fusion_weight = fusion_weight
        self.dtype = dtype
        self.visual = VisionTransformer(arch, sparse_alpha=sparse_alpha,
                                        remat=remat, pipe_stages=pipe_stages,
                                        pipe_microbatches=pipe_microbatches)
        # frame-parallel eval (TPU.SHARD_FRAMES): a callable that stands
        # in for ``visual`` (parallel/local.py::FrameParallelTower)
        self.tower_runner = None
        if dist is not None:
            self.dist_net = DiSTNetwork(dist, d_model=arch.vision_width,
                                        output_dim=arch.embed_dim,
                                        fused_temporal=fused_temporal,
                                        remat=remat)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.head = None

    @property
    def out_dim(self):
        """The width a head over ``vid_logits`` takes: the embedding's."""
        return self.arch.embed_dim

    def attach_head(self, head):
        """Make ``head`` (a head with weights over this module's output
        dict) the child ``head``: the forward then returns its ``(preds,
        logits)``, and the optimizer, the EMA copy and the checkpoints
        see its weights as ``head.*``."""
        self.head = head

    def init_own(self, generator):
        super().init_own(generator)
        self.logit_scale.fill_(float(torch.log(torch.tensor(1.0 / 0.07))))

    @staticmethod
    def is_text_param(name):
        """Whether ``name`` (of ``named_parameters``) is the text tower's:
        those sit at the root, beside ``visual``, ``dist_net``, ``head``
        and ``logit_scale``."""
        return (not name.startswith(("visual.", "dist_net.", "head."))
                and name != "logit_scale")

    def encode_text(self, tokens):
        """Label-prompt features (num_classes, embed_dim); run once."""
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_text):
            feats, _ = TextTransformer.forward(self, tokens, dtype=self.dtype)
        return feats

    def encode_video(self, video):
        """video (B, T, H, W, 3) -> (per-video embedding (B, embed_dim),
        per-frame cls embeddings (B*t, embed_dim))."""
        if video.shape[1] % self.sparse_alpha:
            raise ValueError(
                f"NUM_INPUT_FRAMES ({video.shape[1]}) must be divisible by "
                f"SPARSE_SAMPLE_ALPHA ({self.sparse_alpha})")
        video = video.to(self.dtype)
        tower = self.tower_runner or self.visual
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_visual):
            cls_x, _, taps = tower(video, collect_taps=self.dist is not None)
        if self.dist is None:
            t = self.num_frames // self.sparse_alpha
            return cls_x.reshape(-1, t, cls_x.shape[-1]).mean(dim=1), cls_x
        sel = list(self.dist.selected_layers)
        if sel != list(range(taps.shape[0])):
            taps = taps[torch.tensor(sel, device=taps.device)]
        return self.dist_net(video, taps), cls_x

    def forward(self, video, text_features=None, tokens=None):
        """``tokens`` given: :meth:`encode_text` of them (a call through
        the module, which FSDP's hooks see: ``parallel/fsdp.py``)."""
        if tokens is not None:
            return self.encode_text(tokens)
        out = self._features(video, text_features)
        return out if self.head is None else self.head(out)

    def _features(self, video, text_features):
        video_emb, frame_cls = self.encode_video(video)
        if text_features is None:
            return {"vid_logits": video_emb[:, None, :],
                    "img_logits": frame_cls,
                    "logits_per_image": None}
        v = _normalize(video_emb.float())
        tf = _normalize(text_features.float())
        logit_scale = torch.exp(self.logit_scale.float())
        logits_per_image = logit_scale * v @ tf.T
        if self.prediction_fusion:
            # zero-shot logits from the frozen per-frame cls embeddings,
            # mean-pooled over frames
            f = _normalize(frame_cls.float())
            zs = (logit_scale * f @ tf.T).reshape(
                logits_per_image.shape[0], -1, tf.shape[0]).mean(dim=1)
            w = self.fusion_weight
            logits_per_image = logits_per_image * w + zs * (1.0 - w)
        return {"logits_per_image": logits_per_image[:, None, :],
                "vid_logits": video_emb[:, None, :],
                "img_logits": frame_cls}


def clip_dist_from_cfg(cfg, arch: Optional[CLIPArchitecture] = None):
    """The model definition from a Config (and an optional sniffed
    architecture; else the preset ``VIDEO.BACKBONE.META_ARCH_NAME``).

    Of the ``TPU.*`` keys ``FUSED_TEMPORAL_NET``, ``REMAT``,
    ``MESH.PIPE`` and ``PIPE_MICROBATCHES`` (the vision tower's pipeline)
    shape the model; the others (the data and model axes, unroll) are
    not the model's. Under
    data parallelism each rank runs the fused kernels on its own batch, so
    ``NUM_GPUS`` and ``NUM_SHARDS`` do not matter here, as in the JAX
    package.
    ``REMAT`` recomputes in the backward each ladder step
    (``DiSTNetwork``) and each block of a tower that trains (the JAX
    package's ``nn.remat`` of the towers' scan body); a frozen tower runs
    under ``no_grad``, keeps nothing for a backward, and runs as without
    it. A head with weights (``ClipVideoHeadLinear``) is attached by the
    model builder (``models/base/models.py``)."""
    if arch is None:
        name = cfg.VIDEO.BACKBONE.META_ARCH_NAME
        if name not in ARCHITECTURES:
            raise ValueError(f"unknown CLIP architecture {name!r}; provide a "
                             f"checkpoint or one of {sorted(ARCHITECTURES)}")
        arch = ARCHITECTURES[name]
    atten_block = cfg.VIDEO.BACKBONE.get("ATTEN_BLOCK", "")
    if atten_block not in ("", "ResidualAttentionBlock",
                           "ResidualAttentionBlockMid"):
        raise ValueError(f"unknown ATTEN_BLOCK {atten_block!r}")
    use_bf16 = bool(cfg.TRAIN.get("MIXED_PRECISION", False)
                    or cfg.TRAIN.get("HALF_PRECISION", False))
    dist = None
    if cfg.VIDEO.BACKBONE.get("DIST") and cfg.VIDEO.BACKBONE.DIST.ENABLE:
        dist = DiSTConfig.from_cfg(cfg)
    zeroshot = bool(cfg.TEST.get("ZEROSHOT") and cfg.TEST.ZEROSHOT.ENABLE)
    tpu = cfg.get("TPU") or {}
    fused = bool(tpu.get("FUSED_TEMPORAL_NET", False))
    return CLIPDiSTModel(
        arch=arch,
        dist=dist,
        num_frames=cfg.DATA.NUM_INPUT_FRAMES,
        sparse_alpha=int(cfg.DATA.get("SPARSE_SAMPLE_ALPHA", 1)),
        freeze_visual=bool(cfg.VIDEO.BACKBONE.get("FREEZE_VISUAL", False)),
        freeze_text=bool(cfg.VIDEO.BACKBONE.get("FREEZE_TEXT", False)),
        prediction_fusion=zeroshot,
        dtype=torch.bfloat16 if use_bf16 else torch.float32,
        fused_temporal=fused,
        remat=bool(tpu.get("REMAT", False)),
        pipe_stages=int((tpu.get("MESH") or {}).get("PIPE", 1) or 1),
        pipe_microbatches=int(tpu.get("PIPE_MICROBATCHES", 0) or 0),
    )
