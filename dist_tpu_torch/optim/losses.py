"""Supervised losses and the loss dispatch (port of
``dist_tpu/optim/losses.py``): cross-entropy, soft-target CE (whenever
mixup/cutmix is on), BCE, MSE and label smoothing; dict-valued labels
(EPIC verb/noun) sum the per-key losses; under ``PRETRAIN.ENABLE`` the
SSL losses of ``optim/contrastive.py``, under ``LOCALIZATION.ENABLE``
the BMN losses of ``optim/localization.py``. Losses are fp32 0-d tensors
(float64 for float64 predictions)."""

import torch
import torch.nn.functional as F

from dist_tpu_torch.models.precision import island_dtype


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


def _weighted_parts(section, registry, preds, logits, labels, cur_epoch,
                    cfg):
    """``section.LOSS`` split on ``+``, each part weighted by its
    ``section.LOSS_WEIGHTS`` entry; a part's entries whose name holds
    "debug" are reported and not summed."""
    loss, loss_in_parts = 0.0, {}
    weights = list(section.LOSS_WEIGHTS)
    for idx, item in enumerate(section.LOSS.split("+")):
        fn = registry.get_strict("Loss_" + item)
        parts, _ = fn(cfg, preds, logits, labels, cur_epoch)
        for k, v in parts.items():
            loss_in_parts[k] = v
            if "debug" not in k:
                loss = loss + weights[idx] * v
    return loss, loss_in_parts


def ssl_loss(cfg, preds, logits, labels, cur_epoch=0.0):
    """The SSL losses of ``PRETRAIN.LOSS`` on
    ``labels["self-supervised"]``."""
    from dist_tpu_torch.optim.contrastive import SSL_LOSSES

    return _weighted_parts(cfg.PRETRAIN, SSL_LOSSES, preds, logits,
                           labels.get("self-supervised", {}), cur_epoch, cfg)


def localization_loss(cfg, preds, logits, labels, cur_epoch=0):
    """The BMN losses of ``LOCALIZATION.LOSS`` on ``labels`` (their maps
    under ``"supervised"``); ``cur_epoch`` is the step, which seeds
    ``Loss_PemReg``'s sampling."""
    from dist_tpu_torch.optim.localization import LOCALIZATION_LOSSES

    return _weighted_parts(cfg.LOCALIZATION, LOCALIZATION_LOSSES, preds,
                           logits, labels, cur_epoch, cfg)


def calculate_loss(cfg, preds, logits, labels, cur_epoch=0.0):
    """The loss. ``labels`` is the dataset's dict: {"supervised": ...,
    "supervised_mixup": ..., "self-supervised": {"contrastive": ...}}.
    Returns (loss, loss_in_parts)."""
    if cfg.PRETRAIN.ENABLE:
        return ssl_loss(cfg, preds, logits, labels, cur_epoch)
    if cfg.LOCALIZATION.ENABLE:
        return localization_loss(cfg, preds, logits, labels, cur_epoch)
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
