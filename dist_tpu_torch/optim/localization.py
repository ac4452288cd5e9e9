"""The BMN temporal-action-localization losses (port of
``dist_tpu/optim/localization.py``): the TEM boundary loss, the PEM
regression and classification losses and the per-proposal verb/noun
loss. Each takes ``labels["supervised"]`` = {"start_map", "end_map"
(B, T), "iou_map", "mask" (B, D, T), "label_map" (B, 2, D, T)} and
returns ``({name: loss}, None)``, in fp32 (float64 for float64
predictions).

``Loss_PemReg`` samples its mid- and low-IoU cells with uniform draws.
The JAX package draws them with ``jax.random`` from the step; the port
draws them from a CPU ``torch.Generator`` seeded from the step
(:func:`pem_reg_draws`), so that the card and the CPU draw the same, and
takes the draws as an argument, through which the tests feed it the JAX
package's.
"""

import torch
import torch.nn.functional as F

from dist_tpu_torch.models.precision import island_dtype
from dist_tpu_torch.utils.registry import Registry

LOCALIZATION_LOSSES = Registry("Localization_Losses")

_EPS = 1e-6


def _wide(x):
    return x.to(island_dtype(x))


def _balanced_binary_log_loss(pred, gt, mask=None):
    """Positive/negative re-weighted binary log loss."""
    pred = _wide(pred).reshape(-1)
    gt = gt.reshape(-1).to(pred.dtype)
    mask = (torch.ones_like(pred) if mask is None
            else mask.reshape(-1).to(pred.dtype))
    pmask = (gt > 0.5).to(pred.dtype) * mask
    num_entries = mask.sum()
    num_positive = pmask.sum().clamp(min=1.0)
    ratio = num_entries / num_positive
    coef_0 = 0.5 * ratio / (ratio - 1.0).clamp(min=_EPS)
    coef_1 = 0.5 * ratio
    loss_pos = coef_1 * torch.log(pred + _EPS) * pmask * mask
    loss_neg = coef_0 * torch.log(1.0 - pred + _EPS) * (1.0 - pmask) * mask
    return -(loss_pos + loss_neg).mean()


@LOCALIZATION_LOSSES.register()
def Loss_Tem(cfg, preds, logits, labels, cur_epoch=0):
    """The start and end boundary losses, summed."""
    gt = labels["supervised"]
    loss = (_balanced_binary_log_loss(preds["start"], gt["start_map"])
            + _balanced_binary_log_loss(preds["end"], gt["end_map"]))
    return {"tem": loss}, None


def pem_reg_draws(shape, step):
    """``Loss_PemReg``'s two uniform draws of ``shape`` for step
    ``step``, from a CPU generator seeded from the step alone."""
    gen = torch.Generator().manual_seed(
        hash((0, int(step) * 1000)) & 0x7FFFFFFFFFFFFFFF)
    return torch.rand(shape, generator=gen), torch.rand(shape, generator=gen)


@LOCALIZATION_LOSSES.register()
def Loss_PemReg(cfg, preds, logits, labels, cur_epoch=0, draws=None):
    """The proposals' confidence regression on the high-IoU cells and a
    sample of the mid- and low-IoU cells, drawn so that each set counts
    about as many as the high one. ``draws``: two uniform tensors of the
    IoU map's shape; default :func:`pem_reg_draws` of ``cur_epoch``, the
    step."""
    pred = _wide(preds["confidence_map"][:, 0])
    gt = labels["supervised"]["iou_map"].to(pred.dtype)
    mask = labels["supervised"]["mask"].to(pred.dtype)
    gt = gt * mask
    pos_t = float(cfg.LOCALIZATION.get("POS_REG_THRES", 0.7))
    neg_t = float(cfg.LOCALIZATION.get("NEG_REG_THRES", 0.3))

    u_h = (gt > pos_t).to(pred.dtype)
    u_m = ((gt <= pos_t) & (gt > neg_t)).to(pred.dtype)
    u_l = ((gt <= neg_t) & (gt > 0.0)).to(pred.dtype) * mask

    num_h = u_h.sum()
    r_m = num_h / u_m.sum().clamp(min=1.0)
    r_l = num_h / u_l.sum().clamp(min=1.0)
    if draws is None:
        draws = pem_reg_draws(tuple(gt.shape), cur_epoch)
    d1, d2 = (torch.as_tensor(d).to(device=gt.device, dtype=pred.dtype)
              for d in draws)
    # sampled only within their candidate sets (the JAX package's rule)
    u_sm = u_m * (d1 > (1.0 - r_m)).to(pred.dtype)
    u_sl = u_l * (d2 > (1.0 - r_l)).to(pred.dtype)
    weights = u_h + u_sm + u_sl

    se = (pred * weights - gt * weights) ** 2
    loss = 0.5 * se.sum() / weights.sum().clamp(min=1.0)
    return {"pem_reg": loss}, None


@LOCALIZATION_LOSSES.register()
def Loss_PemCls(cfg, preds, logits, labels, cur_epoch=0):
    """The proposals' binary classification, positives above
    ``POS_CLS_THRES``."""
    pred = _wide(preds["confidence_map"][:, 1])
    gt = labels["supervised"]["iou_map"].to(pred.dtype)
    mask = labels["supervised"]["mask"].to(pred.dtype)
    gt = gt * mask
    pos_t = float(cfg.LOCALIZATION.get("POS_CLS_THRES", 0.9))

    pmask = (gt > pos_t).to(pred.dtype)
    nmask = (gt <= pos_t).to(pred.dtype) * mask
    num_positive = pmask.sum().clamp(min=1.0)
    num_entries = num_positive + nmask.sum()
    ratio = num_entries / num_positive
    coef_0 = 0.5 * ratio / (ratio - 1.0).clamp(min=_EPS)
    coef_1 = 0.5 * ratio
    loss_pos = coef_1 * torch.log(pred + _EPS) * pmask
    loss_neg = coef_0 * torch.log(1.0 - pred + _EPS) * nmask
    loss = -(loss_pos + loss_neg).sum() / num_entries
    return {"pem_cls": loss}, None


@LOCALIZATION_LOSSES.register()
def Loss_BmnActionCls(cfg, preds, logits, labels, cur_epoch=0):
    """Per-proposal verb and noun cross-entropy over the proposals whose
    IoU is at least 0.75. As the JAX package's, it takes the softmax
    cross-entropy of ``verb_map``/``noun_map``, which are already
    softmax scores."""
    gt_label = labels["supervised"]["label_map"]          # (B, 2, D, T)
    iou = labels["supervised"]["iou_map"] * labels["supervised"]["mask"]
    sel = (iou >= 0.75).reshape(-1)

    def head_loss(pred_map, gt_idx):
        p = _wide(pred_map)
        c = p.shape[1]
        p = p.reshape(p.shape[0], c, -1).transpose(1, 2).reshape(-1, c)
        ce = F.cross_entropy(p, gt_idx.reshape(-1).long(), reduction="none")
        w = sel.to(ce.dtype)
        return (ce * w).sum() / w.sum().clamp(min=1.0)

    return {"verb_loss": head_loss(preds["verb_map"], gt_label[:, 0]),
            "noun_loss": head_loss(preds["noun_map"], gt_label[:, 1])}, None
