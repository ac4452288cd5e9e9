"""CLIP + DiST video model (port of ``dist_tpu/models/clip/clip_video.py``).

Label-text features are computed once by :meth:`CLIPDiSTModel.encode_text`
and passed into every forward, as in the JAX package. A frozen tower runs
under ``torch.no_grad()`` (the JAX package's ``stop_gradient``): nothing of
it enters the autograd graph, so the attention kernel, which has no
backward, serves it in a train step too. Video is (B, T, H, W, 3)
channels-last throughout.
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
      vid_logits (B, 1, embed_dim); img_logits (B*t, embed_dim).
    """

    def __init__(self, arch: CLIPArchitecture, dist: Optional[DiSTConfig] = None,
                 num_frames=16, sparse_alpha=1, freeze_visual=True,
                 freeze_text=True, prediction_fusion=False, fusion_weight=0.5,
                 dtype=torch.float32, fused_temporal=False, remat=False):
        super().__init__(arch)
        self.dist = dist
        self.num_frames = num_frames
        self.sparse_alpha = sparse_alpha
        self.freeze_visual = freeze_visual
        self.freeze_text = freeze_text
        self.prediction_fusion = prediction_fusion
        self.fusion_weight = fusion_weight
        self.dtype = dtype
        self.visual = VisionTransformer(arch, sparse_alpha=sparse_alpha)
        if dist is not None:
            self.dist_net = DiSTNetwork(dist, d_model=arch.vision_width,
                                        output_dim=arch.embed_dim,
                                        fused_temporal=fused_temporal,
                                        remat=remat)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def init_own(self, generator):
        super().init_own(generator)
        self.logit_scale.fill_(float(torch.log(torch.tensor(1.0 / 0.07))))

    @staticmethod
    def is_text_param(name):
        """Whether ``name`` (of ``named_parameters``) is the text tower's:
        those sit at the root, beside ``visual``, ``dist_net`` and
        ``logit_scale``."""
        return (not name.startswith(("visual.", "dist_net."))
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
        with torch.set_grad_enabled(torch.is_grad_enabled()
                                    and not self.freeze_visual):
            cls_x, _, taps = self.visual(video,
                                         collect_taps=self.dist is not None)
        if self.dist is None:
            t = self.num_frames // self.sparse_alpha
            return cls_x.reshape(-1, t, cls_x.shape[-1]).mean(dim=1), cls_x
        sel = list(self.dist.selected_layers)
        if sel != list(range(taps.shape[0])):
            taps = taps[torch.tensor(sel, device=taps.device)]
        return self.dist_net(video, taps), cls_x

    def forward(self, video, text_features=None):
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

    Of the ``TPU.*`` keys ``FUSED_TEMPORAL_NET`` and ``REMAT`` shape the
    model; the others (mesh, unroll, pipeline) are not the model's. Under
    data parallelism each rank runs the fused kernels on its own batch, so
    ``NUM_GPUS`` and ``NUM_SHARDS`` do not matter here, as in the JAX
    package.
    ``REMAT`` recomputes the ladder's steps in the backward
    (``DiSTNetwork``). The JAX package also remats the CLIP towers' scan
    body; here a frozen tower runs under ``no_grad`` and keeps nothing for
    a backward, and an unfrozen one cannot train on the card until the
    attention kernel has a backward (ROADMAP.md queue A: An attention
    backward)."""
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
    )
