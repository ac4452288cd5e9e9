"""Classification metrics (port of ``dist_tpu/utils/metrics.py``):
top-k counts, errors and accuracies, and the EPIC joint verb-noun top-k
(the outer product of the verb and noun scores), on torch tensors."""

import torch


def topks_correct(preds, labels, ks, weights=None):
    """Number of top-k correct predictions for each k, as 0-d float32
    tensors on ``preds``' device. preds (N, C), labels (N,); k is clamped
    to the class count. ``weights`` (N,) optional per-sample weights (eval
    zeroes the loader's pad duplicates with them)."""
    c = preds.shape[-1]
    max_k = min(max(ks), c)
    top_idx = torch.topk(preds, max_k, dim=-1).indices         # (N, max_k)
    correct = (top_idx == labels[:, None]).float()
    if weights is not None:
        correct = correct * weights.float()[:, None]
    return [correct[:, :min(k, c)].sum() for k in ks]


def topk_errors(preds, labels, ks):
    """(1 - #correct/N) * 100 per k."""
    n = preds.shape[0]
    return [(1.0 - c / n) * 100.0 for c in topks_correct(preds, labels, ks)]


def topk_accuracies(preds, labels, ks):
    """#correct/N * 100 per k."""
    n = preds.shape[0]
    return [(c / n) * 100.0 for c in topks_correct(preds, labels, ks)]


def joint_topks_correct(verb_preds, noun_preds, verb_labels, noun_labels, ks,
                        normalized=False, weights=None):
    """EPIC joint action top-k: outer product of verb/noun scores. Returns
    {"verb_top{k}", "noun_top{k}", "action_top{k}"} correct counts.

    ``normalized=True`` skips the softmax (eval-mode heads already emit
    softmax scores)."""
    n = verb_preds.shape[0]
    vp, np_ = verb_preds.float(), noun_preds.float()
    if not normalized:
        vp, np_ = torch.softmax(vp, dim=-1), torch.softmax(np_, dim=-1)
    flat = (vp[:, :, None] * np_[:, None, :]).reshape(n, -1)   # (N, V * Nn)
    labels_flat = verb_labels * noun_preds.shape[-1] + noun_labels
    out = {}
    for name, p, l in (("verb", verb_preds, verb_labels),
                       ("noun", noun_preds, noun_labels),
                       ("action", flat, labels_flat)):
        for k, c in zip(ks, topks_correct(p, l, ks, weights=weights)):
            out[f"{name}_top{k}"] = c
    return out
