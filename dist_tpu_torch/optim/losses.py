"""Supervised losses and the loss dispatch (port of the supervised path of
``dist_tpu/optim/losses.py``): cross-entropy, soft-target CE (whenever
mixup/cutmix is on), BCE, MSE and label smoothing; dict-valued labels
(EPIC verb/noun) sum the per-key losses. Losses are fp32 0-d tensors
(float64 for float64 predictions)."""

import torch
import torch.nn.functional as F

from dist_tpu_torch.models.precision import island_dtype

_NOT_PORTED = ("is not ported yet: the PyTorch port trains the supervised "
               "path only (ROADMAP.md queue A: SSL/HiCo pretraining, "
               "TAL)")


def soft_target_cross_entropy(logits, target):
    """sum(-target * log_softmax(x)).mean()."""
    logp = F.log_softmax(_wide(logits), dim=-1)
    return (-target * logp).sum(dim=-1).mean()


def _wide(x):
    """``x`` in fp32, or float64 if it is float64."""
    return x.to(island_dtype(x))


def cross_entropy(logits, labels):
    """Plain CE on integer labels."""
    return F.cross_entropy(_wide(logits), labels.long())


def bce(probs, target):
    eps = 1e-7
    p = _wide(probs).clamp(eps, 1 - eps)
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def bce_logit(logits, target):
    logits = _wide(logits)
    return F.binary_cross_entropy_with_logits(logits, target.to(logits.dtype))


def mse(pred, target):
    return ((_wide(pred) - target) ** 2).mean()


_LOSSES = {
    "cross_entropy": cross_entropy,
    "soft_target": soft_target_cross_entropy,
    "bce": bce,
    "bce_logit": bce_logit,
    "mse": mse,
}


def get_loss_func(name):
    if name not in _LOSSES:
        raise NotImplementedError(f"Loss {name} is not supported")
    return _LOSSES[name]


def label_smoothing(labels, num_classes, smoothing):
    """int labels -> smoothed one-hot: on-value 1 - s + s/C, off-value s/C."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    one_hot = F.one_hot(labels.long(), num_classes).float()
    return one_hot * (on - off) + off


def calculate_loss(cfg, preds, logits, labels, cur_epoch=0.0):
    """The loss of the supervised path. ``labels`` is the dataset's dict:
    {"supervised": ..., "supervised_mixup": ...}. Returns
    (loss, loss_in_parts)."""
    del logits, cur_epoch        # read by the SSL and TAL losses only
    if cfg.PRETRAIN.ENABLE:
        raise NotImplementedError(f"PRETRAIN.ENABLE {_NOT_PORTED}")
    if cfg.LOCALIZATION.ENABLE:
        raise NotImplementedError(f"LOCALIZATION.ENABLE {_NOT_PORTED}")
    loss_in_parts = {}
    loss_fun = get_loss_func(cfg.TRAIN.get("LOSS_FUNC", "cross_entropy"))

    def per_key(fn, target):
        loss = 0.0
        for k, v in target.items():
            loss_in_parts["loss_" + k] = fn(preds[k], v)
            loss = loss + loss_in_parts["loss_" + k]
        return loss

    if "supervised_mixup" in labels:
        # mixup targets are soft: the soft-target loss whatever LOSS_FUNC
        target = labels["supervised_mixup"]
        if isinstance(target, dict):
            return per_key(soft_target_cross_entropy, target), loss_in_parts
        return soft_target_cross_entropy(preds, target), loss_in_parts

    target = labels["supervised"]
    smoothing = float(cfg.AUGMENTATION.get("LABEL_SMOOTHING", 0.0))
    if smoothing > 0.0:
        def smoothed(p, v):
            return soft_target_cross_entropy(
                p, label_smoothing(v, p.shape[-1], smoothing))

        if isinstance(target, dict):
            return per_key(smoothed, target), loss_in_parts
        return smoothed(preds, target), loss_in_parts
    if isinstance(target, dict):
        return per_key(loss_fun, target), loss_in_parts
    return loss_fun(preds, target), loss_in_parts
