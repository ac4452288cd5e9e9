"""Batch-mode Mixup/CutMix on the device (port of
``dist_tpu/data/mixup.py``).

Split in two, so that a draw can come from any random stream: :func:`draw`
takes the batch's random numbers from a ``torch.Generator`` on the host
(the JAX package draws them from a ``jax.random`` key inside its step), and
:func:`apply` mixes the batch with them. One lambda per batch; the batch is
mixed with itself reversed. CutMix pastes a box of the reversed batch and
corrects lambda by the box's true area; the targets are smoothed one-hot
labels mixed by lambda. Every value of a draw is a float32 number, so the
mix rounds as the JAX package's does."""

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from dist_tpu_torch.optim.losses import label_smoothing


@dataclasses.dataclass(frozen=True)
class MixupConfig:
    mixup_alpha: float = 0.8
    cutmix_alpha: float = 1.0
    cutmix_minmax: Optional[tuple] = None   # box side range; overrides alpha
    mix_prob: float = 1.0
    switch_prob: float = 0.5
    smoothing: float = 0.1
    num_classes: int = 0
    mode: str = "batch"

    @classmethod
    def from_cfg(cls, cfg):
        aug = cfg.AUGMENTATION
        minmax = aug.CUTMIX.get("MINMAX") if aug.CUTMIX.ENABLE else None
        minmax = tuple(float(v) for v in minmax) if minmax else None
        cutmix_alpha = float(aug.CUTMIX.ALPHA) if aug.CUTMIX.ENABLE else 0.0
        if minmax is not None and cutmix_alpha <= 0:
            # a min-max range turns cutmix on whatever its alpha (timm)
            cutmix_alpha = 0.5
        return cls(
            mixup_alpha=float(aug.MIXUP.ALPHA),
            cutmix_alpha=cutmix_alpha,
            cutmix_minmax=minmax,
            mix_prob=float(aug.MIXUP.PROB),
            switch_prob=float(aug.MIXUP.SWITCH_PROB),
            smoothing=float(aug.LABEL_SMOOTHING),
            num_classes=int(cfg.VIDEO.HEAD.NUM_CLASSES),
            mode=aug.MIXUP.MODE,
        )

    @property
    def enabled(self):
        return self.mixup_alpha > 0 or self.cutmix_alpha > 0


@dataclasses.dataclass(frozen=True)
class MixupDraw:
    """The random choices of one batch. ``lam_cut`` is already corrected to
    the box's area; ``box`` is (y_lo, y_hi, x_lo, x_hi), half-open."""

    use_mix: bool
    use_cutmix: bool
    lam_mix: float
    lam_cut: float
    box: Tuple[int, int, int, int]


def bbox_and_lam(h, w, lam, cy, cx):
    """CutMix's square box of area ~(1 - lam) centred at (cy, cx), clipped
    to the image, and lambda corrected to its area; float32 arithmetic as
    the JAX package's ``_rand_bbox_mask``."""
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    cut_h = int(np.float32(h) * ratio)
    cut_w = int(np.float32(w) * ratio)
    yl, yh = np.clip([cy - cut_h // 2, cy + cut_h // 2], 0, h)
    xl, xh = np.clip([cx - cut_w // 2, cx + cut_w // 2], 0, w)
    return (int(yl), int(yh), int(xl), int(xh)), _area_lam(
        (yh - yl) * (xh - xl), h, w)


def _area_lam(area, h, w):
    """1 - area / (h * w), in float32."""
    one, hw = np.float32(1.0), np.float32(h * w)
    return float(one - np.float32(area) / hw)


def _beta(alpha, generator):
    """One Beta(alpha, alpha) draw in float32, from two Gamma draws."""
    a = torch._standard_gamma(torch.tensor([alpha, alpha]),
                              generator=generator)
    return float(np.float32(a[0] / (a[0] + a[1])))


def draw(mc: MixupConfig, generator, h, w):
    """One batch's :class:`MixupDraw` for (h, w) frames, from
    ``generator`` (a CPU ``torch.Generator``; no device work)."""
    if mc.mode != "batch":
        raise NotImplementedError(f"mixup mode {mc.mode} is not ported")
    u = torch.rand(2, generator=generator)
    use_mix = bool(u[0] < mc.mix_prob)
    if mc.mixup_alpha > 0 and mc.cutmix_alpha > 0:
        use_cutmix = bool(u[1] < mc.switch_prob)
    else:
        use_cutmix = mc.cutmix_alpha > 0
    lam_mix = _beta(mc.mixup_alpha, generator) if mc.mixup_alpha > 0 else 1.0
    if mc.cutmix_minmax is not None:
        lo, hi = mc.cutmix_minmax
        cut_h = int(torch.randint(int(h * lo), int(h * hi), (),
                                  generator=generator))
        cut_w = int(torch.randint(int(w * lo), int(w * hi), (),
                                  generator=generator))
        yl = int(torch.randint(0, h - cut_h, (), generator=generator))
        xl = int(torch.randint(0, w - cut_w, (), generator=generator))
        box = (yl, yl + cut_h, xl, xl + cut_w)
        lam_cut = _area_lam(cut_h * cut_w, h, w)
    else:
        lam = (_beta(mc.cutmix_alpha, generator) if mc.cutmix_alpha > 0
               else 1.0)
        cy = int(torch.randint(0, h, (), generator=generator))
        cx = int(torch.randint(0, w, (), generator=generator))
        box, lam_cut = bbox_and_lam(h, w, lam, cy, cx)
    return MixupDraw(use_mix, use_cutmix, lam_mix, lam_cut, box)


def apply(video, labels, d: MixupDraw, mc: MixupConfig):
    """video (B, T, H, W, C) float, labels (B,) int, both on one device ->
    (mixed video in video's dtype, soft targets (B, num_classes) fp32)."""
    flipped = video.flip(0)
    if not d.use_mix:
        mixed, lam = video, np.float32(1.0)
    elif d.use_cutmix:
        yl, yh, xl, xh = d.box
        mixed = video.clone()
        mixed[:, :, yl:yh, xl:xh] = flipped[:, :, yl:yh, xl:xh]
        lam = np.float32(d.lam_cut)
    else:
        lam = np.float32(d.lam_mix)
        mixed = video * float(lam) + flipped * float(np.float32(1.0) - lam)
    y1 = label_smoothing(labels, mc.num_classes, mc.smoothing)
    y2 = label_smoothing(labels.flip(0), mc.num_classes, mc.smoothing)
    target = y1 * float(lam) + y2 * float(np.float32(1.0) - lam)
    return mixed.to(video.dtype), target
