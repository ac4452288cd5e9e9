"""Classification metrics (port of ``topks_correct`` of
``dist_tpu/utils/metrics.py``); the EPIC joint metrics come with the eval
run-list slice."""

import torch


def topks_correct(preds, labels, ks, weights=None):
    """Number of top-k correct predictions for each k, as 0-d float32
    tensors on ``preds``' device. preds (N, C), labels (N,); k is clamped
    to the class count. ``weights`` (N,) optional per-sample weights."""
    c = preds.shape[-1]
    max_k = min(max(ks), c)
    top_idx = torch.topk(preds, max_k, dim=-1).indices         # (N, max_k)
    correct = (top_idx == labels[:, None]).float()
    if weights is not None:
        correct = correct * weights.float()[:, None]
    return [correct[:, :min(k, c)].sum() for k in ks]
