"""Eval-step pieces of ``dist_tpu/tasks/state.py``: video preparation, the
once-per-engine label-text features and the eval step's predictions.
The train step comes with the training slice."""

import os

import torch

from dist_tpu_torch.data.transforms import normalize_device
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def load_pretrained(cfg, model):
    """Load the configured CLIP weights (``LOCAL_PRETRAIN_WEIGHT_PATH`` or
    ``PRETRAIN_WEIGHT_PATH``) when the file exists; otherwise keep the
    random weights."""
    w = (cfg.VIDEO.BACKBONE.get("LOCAL_PRETRAIN_WEIGHT_PATH")
         or cfg.VIDEO.BACKBONE.get("PRETRAIN_WEIGHT_PATH"))
    if w and os.path.exists(w):
        from dist_tpu_torch.utils.checkpoint import load_torch_weights
        load_torch_weights(model, w)
    return model


@torch.no_grad()
def compute_text_features(model, text_tokens):
    """Encode the label texts once; None without tokens."""
    if text_tokens is None:
        return None
    tokens = torch.as_tensor(text_tokens, dtype=torch.long, device=model.device)
    return model.encode_text(tokens)


def _prep_video(cfg, video):
    """uint8 batches are normalised on the device."""
    if video.dtype == torch.uint8:
        return normalize_device(video, list(cfg.DATA.MEAN), list(cfg.DATA.STD))
    return video


def make_eval_step(model, cfg):
    """eval step: batch {"video", "text_features"} -> {"preds"} (the
    metrics of the JAX step come with the eval run-list slice)."""

    @torch.no_grad()
    def step(batch):
        inputs = {"video": _prep_video(cfg, batch["video"]),
                  "text_features": batch.get("text_features")}
        preds, _ = model.apply(inputs, train=False)
        return {"preds": preds}

    return step
