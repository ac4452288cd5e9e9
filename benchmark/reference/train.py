"""The plain reference of a training step, as the configurations state
it: the video normalised, mixed (batch-mode Mixup or CutMix, one draw a
step from the seed and the step, with label-smoothed soft targets), the
soft-target cross-entropy over the classifier's logits, the gradient,
and AdamW with decoupled weight decay at the step's learning rate
(linear warm-up, then cosine). Its random draws are worked out again from
the configuration's seed and the step, as the release draws them; it
takes nothing from the program.

Large batches are run in blocks of rows (``block``), their gradients
summed, so that the fp32 reference fits beside nothing else on the card."""

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.model import logits, normalize_video, text_tower

_MASK64 = 0x7FFFFFFFFFFFFFFF


def step_generator(seed, step):
    """The step's CPU generator: seeded from (seed, step) alone."""
    return torch.Generator().manual_seed(hash((int(seed), int(step))) & _MASK64)


def dropout_seed(seed, step):
    """The seed of the step's dropout draws (rank 0 of one data shard)."""
    return hash((int(seed), int(step), 0)) & _MASK64


# ---------------- Mixup and CutMix ----------------


def _beta(alpha, gen):
    a = torch._standard_gamma(torch.tensor([alpha, alpha]), generator=gen)
    return float(np.float32(a[0] / (a[0] + a[1])))


def _area_lam(area, h, w):
    return float(np.float32(1.0) - np.float32(area) / np.float32(h * w))


def mix_draw(m, gen, h, w):
    """(use_mix, use_cutmix, lam_mix, lam_cut, box) of one batch."""
    u = torch.rand(2, generator=gen)
    use_mix = bool(u[0] < m["prob"])
    use_cutmix = bool(u[1] < m["switch_prob"])
    lam_mix = _beta(m["mixup_alpha"], gen)
    lam = _beta(m["cutmix_alpha"], gen)
    cy = int(torch.randint(0, h, (), generator=gen))
    cx = int(torch.randint(0, w, (), generator=gen))
    ratio = np.sqrt(np.float32(1.0) - np.float32(lam))
    ch, cw = int(np.float32(h) * ratio), int(np.float32(w) * ratio)
    yl, yh = np.clip([cy - ch // 2, cy + ch // 2], 0, h)
    xl, xh = np.clip([cx - cw // 2, cx + cw // 2], 0, w)
    box = (int(yl), int(yh), int(xl), int(xh))
    return use_mix, use_cutmix, lam_mix, _area_lam((yh - yl) * (xh - xl), h, w), box


def smoothed(labels, classes, s):
    off = s / classes
    return F.one_hot(labels.long(), classes).float() * (1.0 - s) + off


def mix(video, labels, draw, classes, smoothing):
    """-> (mixed video, soft targets (B, classes))."""
    use_mix, use_cut, lam_mix, lam_cut, box = draw
    flipped = video.flip(0)
    if not use_mix:
        mixed, lam = video, np.float32(1.0)
    elif use_cut:
        yl, yh, xl, xh = box
        mixed = video.clone()
        mixed[:, :, yl:yh, xl:xh] = flipped[:, :, yl:yh, xl:xh]
        lam = np.float32(lam_cut)
    else:
        lam = np.float32(lam_mix)
        mixed = video * float(lam) + flipped * float(np.float32(1.0) - lam)
    y1 = smoothed(labels, classes, smoothing)
    y2 = smoothed(labels.flip(0), classes, smoothing)
    return mixed, y1 * float(lam) + y2 * float(np.float32(1.0) - lam)


# ---------------- the optimizer ----------------


def learning_rate(t, step):
    """The schedule's rate at ``step``: linear warm-up from
    ``warmup_start_lr`` to the cosine's value, then the cosine."""
    epoch = step / float(t["steps_per_epoch"])

    def cosine(e):
        return t["base_lr"] * (math.cos(math.pi * e / t["max_epoch"]) + 1.0) * 0.5

    if t["warmup_epochs"] > 0 and epoch < t["warmup_epochs"]:
        start = t["warmup_start_lr"]
        return epoch * (cosine(t["warmup_epochs"]) - start) / t["warmup_epochs"] + start
    return cosine(epoch)


def groups(t, w):
    """{name: weight decay} of the leaves that train, by the release's
    rules: DiST trains its side network alone and decays no bias, token,
    embedding or one-dimensional leaf; the fine-tune trains everything
    and spares tokens and embeddings."""
    out = {}
    for name, p in w.items():
        if t["rule"] == "dist":
            if "dist_net" not in name and "head" not in name:
                continue
            no_wd = (name.endswith(("cls_token", "positional_embedding", "bias"))
                     or "embd" in name or "embed" in name or p.dim() <= 1)
        else:
            no_wd = (name.endswith(("cls_token", "positional_embedding"))
                     or "embd" in name or "embed" in name)
        out[name] = 0.0 if no_wd else t["weight_decay"]
    return out


class AdamW:
    """torch's AdamW arithmetic on a dict of leaves."""

    def __init__(self, params, decay, betas, eps=1e-8):
        self.params, self.decay = params, decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads.get(k)
            if g is None:
                g = torch.zeros_like(p)
            p.mul_(1 - lr * self.decay[k])
            self.m[k].lerp_(g, 1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


# ---------------- the steps ----------------


def run_steps(P, weights, batches, spec, seed, tokens=None, fault=None):
    """The configuration's training steps from ``weights`` (a dict of
    fp32 tensors, left as it is) over ``batches`` ({"video" uint8
    (B, T, H, W, 3), "labels" (B,)} on one device). ``seed`` is the
    configuration's seed (its draws are seed + 1 for the mix, seed + 2
    for the dropout). ``fault="half_batch"`` takes the loss's mean over
    the first half of the rows alone.

    Returns {"loss": [per step], "grad": {leaf: first step's gradient},
    "change": {leaf: weights after the steps less before}} for the leaves
    that train."""
    t = spec["train"]
    w = {k: v.detach().clone() for k, v in weights.items()}
    decay = groups(t, w)
    train = {k: w[k] for k in decay}
    for p in train.values():
        p.requires_grad_(True)
    opt = AdamW(train, decay, tuple(t["betas"]))
    text = None
    if spec["head"] == "text":
        with torch.no_grad():
            text = text_tower(P, tokens, w, spec["arch"])
    mx = t["mixup"]
    losses, first = [], None
    for step, b in enumerate(batches):
        video = normalize_video(b["video"], spec["mean"], spec["std"])
        h, wd = video.shape[2], video.shape[3]
        draw = mix_draw(mx, step_generator(seed + 1, step), h, wd)
        video, target = mix(video, b["labels"], draw, spec["classes"],
                            t["label_smoothing"])
        n = video.shape[0]
        rows = n // 2 if fault == "half_batch" else n
        drop = None
        if t.get("dropout", 0.0) > 0:
            torch.manual_seed(dropout_seed(seed + 2, step))
            ones = torch.ones(n, spec["arch"]["embed_dim"], device=video.device,
                              dtype=getattr(torch, t["dropout_dtype"]))
            drop = F.dropout(ones, t["dropout"], True).float()
        grads = {}
        total = 0.0
        blk = int(t.get("block", n))
        for lo in range(0, rows, blk):
            hi = min(lo + blk, rows)
            out = logits(P, video[lo:hi], w, spec, text,
                         None if drop is None else drop[lo:hi])
            logp = F.log_softmax(out.float(), dim=-1)
            loss = (-target[lo:hi] * logp).sum() / rows
            g = torch.autograd.grad(loss, list(train.values()),
                                    allow_unused=True)
            for k, gi in zip(train, g):
                if gi is not None:
                    grads[k] = gi if k not in grads else grads[k] + gi
            total += float(loss.detach())
        losses.append(total)
        if first is None:
            first = {k: v.detach().clone() for k, v in grads.items()}
        opt.step(grads, learning_rate(t, step) * t["lr_mult"])
    change = {k: (p.detach() - weights[k]) for k, p in train.items()}
    return {"loss": losses, "grad": first, "change": change}
