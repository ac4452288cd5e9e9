"""The SSL losses: SimCLR's instance discrimination, HiCo and HiCo++
(port of ``dist_tpu/optim/contrastive.py``).

The JAX loss runs on the global batch inside one program. Here each rank
of a group holds its share, so each loss first takes every rank's
embeddings through ``parallel/collectives.py::gather_with_grad`` (the
topical maps arrive gathered from the heads): every rank computes the
global batch's loss, its gradient reaches the rank's own rows, times the
world size, and DDP's mean makes it the global loss's gradient. Row
``b * n + v`` is view ``v`` of video ``b``, the videos in rank order.

Pair selections are mask algebra on the (B, s, B, s) view of the
similarity matrix, as in the JAX package; the losses are fp32 (float64
for float64 embeddings).
"""

import torch

from dist_tpu_torch.models.precision import island_dtype
from dist_tpu_torch.parallel.collectives import gather_with_grad
from dist_tpu_torch.utils.registry import Registry

SSL_LOSSES = Registry("SSL_Losses")


# ------------------------- similarity functions -------------------------


def sim_func_linear(sim, temperature, optim_target=None):
    if optim_target is not None:
        sim = sim.clamp(-1.0, optim_target)
    return torch.exp(sim / temperature)


def sim_func_parabola_pos(sim, temperature, optim_target=1.0):
    return torch.exp((1 - (sim - optim_target) ** 2) / temperature)


def sim_func_parabola_neg(sim, temperature, optim_target=None):
    return torch.exp((sim + 1) ** 2 / temperature)


_SIM_FUNCS = {
    ("linear", "pos"): sim_func_linear,
    ("linear", "neg"): sim_func_linear,
    ("parabola", "pos"): sim_func_parabola_pos,
    ("parabola", "neg"): sim_func_parabola_neg,
}


def get_sim_func(name, pair):
    key = (name, pair)
    if key not in _SIM_FUNCS:
        raise NotImplementedError(f"Unknown similarity function: {name}")
    return _SIM_FUNCS[key]


# ------------------------- mask helpers -------------------------


def _same_instance_mask(batch_size, samples, device):
    """(B*s, B*s) bool: same video, any view."""
    eye = torch.eye(batch_size, dtype=torch.bool, device=device)
    return eye.repeat_interleave(samples, 0).repeat_interleave(samples, 1)


def _pos_pairs(mtx, batch_size, samples):
    """The same-instance entries off the diagonal -> (B*s, s-1), row by
    row in the reference's boolean-indexing order."""
    blocks = mtx.reshape(batch_size, samples, batch_size, samples)
    idx = torch.arange(batch_size, device=mtx.device)
    diag = blocks[idx, :, idx, :]                          # (B, s, s)
    keep = ~torch.eye(samples, dtype=torch.bool, device=mtx.device)
    return diag[:, keep].reshape(batch_size * samples, samples - 1)


def _sims(cfg, logits):
    c = cfg.PRETRAIN.CONTRASTIVE
    sim = logits @ logits.T
    pos = get_sim_func(c.SIM_FUNC_POS, "pos")(
        sim, c.TEMPERATURE, c.get("POS_OPTIM_TARGET", None))
    neg = get_sim_func(c.SIM_FUNC_NEG, "neg")(sim, c.TEMPERATURE)
    return pos, neg


def _neg_sums(neg_mtx, batch_size, samples):
    """(B*s, 1): each column's sum over the other videos' rows."""
    mask = _same_instance_mask(batch_size, samples, neg_mtx.device)
    return ((~mask) * neg_mtx).sum(dim=0)[:, None]


def contrastive_instance_discrimination(cfg, logits, batch_size, samples):
    """NT-Xent instance discrimination -> (loss, mean positive, mean
    negative sum)."""
    c = cfg.PRETRAIN.CONTRASTIVE
    pos_mtx, neg_mtx = _sims(cfg, logits)
    pos = _pos_pairs(pos_mtx, batch_size, samples)          # (B*s, s-1)
    if c.get("INS_MIL", False):
        pos = pos.sum(dim=1, keepdim=True)
    neg = _neg_sums(neg_mtx, batch_size, samples)            # (B*s, 1)
    n = pos.shape[1]
    denom = pos + neg if c.get("WITH_ONE", True) else neg
    loss = -((1.0 / n) * torch.log(pos / denom).sum()) / (batch_size * samples)
    return loss, pos.mean(), neg.mean()


def _tcl_focal(preds, samples_per_group, gama):
    """The topic-consistency focal BCE over the pairwise map ``preds``
    (N, N, ...) of raw scores."""
    p = torch.sigmoid(preds.to(island_dtype(preds)))
    n_tok = p.shape[0]
    groups = n_tok // samples_per_group
    mask_ins = _same_instance_mask(groups, samples_per_group, p.device)
    pos_mask = mask_ins & ~torch.eye(n_tok, dtype=torch.bool, device=p.device)
    neg_mask = ~mask_ins
    while pos_mask.dim() < p.dim():
        pos_mask, neg_mask = pos_mask[..., None], neg_mask[..., None]
    log_eps = 1e-5
    zero = torch.zeros((), dtype=p.dtype, device=p.device)
    pos_terms = torch.where(
        pos_mask, ((1 - p) ** gama) * torch.log(p + log_eps), zero)
    neg_terms = torch.where(
        neg_mask, (p ** gama) * torch.log(1 - p + log_eps), zero)
    # the (N, N) masks' counts, as the JAX package takes them, whatever
    # the map's trailing axes (counted here, not read off the card)
    s = samples_per_group
    pos_cnt = max(groups * s * (s - 1), 1)
    neg_cnt = max(n_tok * n_tok - groups * s * s, 1)
    return -(pos_terms.sum() / pos_cnt) - (neg_terms.sum() / neg_cnt)


def _weighted(cfg, vcl_loss, tcl_loss):
    loss = cfg.HICO.LOSS
    return (vcl_loss * float(loss.VCL_WEIGHT)
            + tcl_loss * float(loss.TCL_WEIGHT))


def contrastive_hico(cfg, preds, logits, batch_size, samples):
    """HiCo: VCL over the first two views of each video, and the TCL focal
    BCE over the topical map -> (loss, mean positive, mean negative sum,
    VCL, TCL)."""
    pos_mtx, neg_mtx = _sims(cfg, logits)
    pos_all = _pos_pairs(pos_mtx, batch_size, samples)       # (B*s, s-1)
    neg_all = _neg_sums(neg_mtx, batch_size, samples)

    # VCL: the rows of the first two views, their first positive column
    view_idx = torch.arange(samples, device=logits.device).repeat(batch_size)
    vcl_mask = view_idx < 2
    vcl_pos = pos_all[:, :1]
    ratio = torch.log(vcl_pos / (vcl_pos + neg_all))[:, 0]
    vcl_loss = -(torch.where(vcl_mask, ratio, torch.zeros_like(ratio)).sum()
                 / max(batch_size * min(samples, 2), 1))

    tcl_loss = _tcl_focal(preds, samples, float(cfg.HICO.LOSS.GAMA))
    return (_weighted(cfg, vcl_loss, tcl_loss), vcl_pos.mean(),
            neg_all.mean(), vcl_loss, tcl_loss)


def contrastive_hico_plus_plus(cfg, preds, logits, batch_size, samples,
                               vit_scale=False):
    """HiCo++: VCL over adjacent view pairs, TCL over half-sample groups;
    ``vit_scale`` multiplies the VCL by twice the temperature."""
    c = cfg.PRETRAIN.CONTRASTIVE
    n_tok = batch_size * samples
    pos_mtx, neg_mtx = _sims(cfg, logits)
    pos = _pos_pairs(pos_mtx, n_tok // 2, 2)                 # pair blocks
    neg = _neg_sums(neg_mtx, batch_size, samples)

    vcl_loss = -torch.log(pos / (pos + neg)).mean()
    if vit_scale:
        vcl_loss = vcl_loss * c.TEMPERATURE * 2

    tcl_loss = _tcl_focal(preds, max(samples // 2, 1),
                          float(cfg.HICO.LOSS.GAMA))
    return (_weighted(cfg, vcl_loss, tcl_loss), pos.mean(), neg.mean(),
            vcl_loss, tcl_loss)


# ------------------------- the registered SSL losses -------------------------


def _global_embeddings(logits, labels):
    """(every rank's embeddings in rank order, videos in the global batch,
    views a video)."""
    emb = logits[0] if isinstance(logits, (list, tuple)) else logits
    emb = gather_with_grad(emb.to(island_dtype(emb)))
    samples = labels["contrastive"].shape[1]
    return emb, emb.shape[0] // samples, samples


@SSL_LOSSES.register()
def Loss_Contrastive(cfg, preds, logits, labels, cur_epoch=0):
    emb, batch_size, samples = _global_embeddings(logits, labels)
    loss, pos, neg = contrastive_instance_discrimination(cfg, emb, batch_size,
                                                         samples)
    return {"loss_contrastive": loss, "pos_debug": pos, "neg_debug": neg}, None


def _hico_parts(total, pos, neg, vcl, tcl):
    return {"total_loss": total, "pos_debug": pos, "neg_debug": neg,
            "vcl_loss_debug": vcl, "tcl_loss_debug": tcl}, None


@SSL_LOSSES.register()
def Loss_HiCo(cfg, preds, logits, labels, cur_epoch=0):
    emb, batch_size, samples = _global_embeddings(logits, labels)
    return _hico_parts(*contrastive_hico(cfg, preds, emb, batch_size, samples))


@SSL_LOSSES.register()
def Loss_HiCoPlusPlus(cfg, preds, logits, labels, cur_epoch=0):
    emb, batch_size, samples = _global_embeddings(logits, labels)
    return _hico_parts(*contrastive_hico_plus_plus(cfg, preds, emb,
                                                   batch_size, samples))


@SSL_LOSSES.register()
def Loss_HiCoPlusPlusVit(cfg, preds, logits, labels, cur_epoch=0):
    emb, batch_size, samples = _global_embeddings(logits, labels)
    return _hico_parts(*contrastive_hico_plus_plus(
        cfg, preds, emb, batch_size, samples, vit_scale=True))

