"""Train state and steps (port of ``dist_tpu/tasks/state.py``): video
preparation, the once-per-run label-text features, the eval step with its
top-k errors over the pad mask, and the supervised train step.

The JAX package's step is one jitted function; here it is eager PyTorch
that queues its work on the card and returns its metrics as 0-d device
tensors, so that the host runs ahead and reads them a step later."""

import contextlib
import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from dist_tpu_torch.data import mixup
from dist_tpu_torch.data.transforms import normalize_device
from dist_tpu_torch.optim.losses import calculate_loss
from dist_tpu_torch.optim.optimizer import set_lr
from dist_tpu_torch.parallel import collectives
from dist_tpu_torch.utils.logging import get_logger
from dist_tpu_torch.utils.metrics import joint_topks_correct, topks_correct

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
    """Encode the label texts once; None without tokens or for a model
    that does not classify against label texts (a conv backbone with
    ``BaseHead``), which has no text tower."""
    if text_tokens is None or not model.is_text_model:
        return None
    tokens = torch.as_tensor(text_tokens, dtype=torch.long, device=model.device)
    return model.encode_text(tokens)


def to_device(x, device, dtype=None):
    """A host array (numpy or a CPU tensor, pinned or not) on ``device``;
    the copy from a pinned tensor is asynchronous."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t.to(device=device, dtype=dtype, non_blocking=True)


def _prep_video(cfg, video):
    """uint8 batches are normalised on the device."""
    if video.dtype == torch.uint8:
        return normalize_device(video, list(cfg.DATA.MEAN), list(cfg.DATA.STD))
    return video


def _epic_errors(preds, verb_labels, noun_labels, normalized, weights=None):
    """Joint verb/noun/action top-1/5 errors for dict predictions: the
    action (joint) errors are the headline top1/top5, the per-head errors
    ride beside them. ``weights``: optional per-sample validity (the
    loader's pad mask)."""
    counts = joint_topks_correct(preds["verb_class"], preds["noun_class"],
                                 verb_labels, noun_labels, (1, 5),
                                 normalized=normalized, weights=weights)
    if weights is not None:
        n = weights.float().sum().clamp(min=1.0)
    else:
        n = preds["verb_class"].shape[0]
    err = {k: (1.0 - v / n) * 100.0 for k, v in counts.items()}
    return (err.pop("action_top1"), err.pop("action_top5"),
            {f"{k.rsplit('_', 1)[1]}_err_{k.rsplit('_', 1)[0]}": v
             for k, v in err.items()})


def make_eval_step(model, cfg, use_ema=False):
    """eval step: ``step(batch, state=None) -> metrics``.

    ``batch`` = {"video", "text_features"} and optionally "labels" (N,)
    and "mask" (N,), the loader's pad mask (0 for a pad duplicate), all
    on the model's device. Returns {"preds"} (per-clip scores), and with
    labels "top1_err" and "top5_err" over the rows the mask keeps, and
    with a mask "num_valid", as 0-d device tensors. Dict predictions
    (EPIC verb/noun heads) give the joint action errors when the batch has
    "label_verb" and "label_noun". ``use_ema`` runs the forward with the
    EMA copy of ``state`` (a :class:`TrainState`)."""
    # heads emit softmax scores at eval only with the softmax activation;
    # the joint metric must not softmax those again
    head_normalized = str(
        cfg.VIDEO.HEAD.get("ACTIVATION", "softmax") or "") == "softmax"

    @torch.no_grad()
    def step(batch, state=None):
        ema = None
        if use_ema:
            if state is None or state.ema is None:
                raise ValueError("use_ema needs a TrainState with an EMA copy")
            ema = state.ema
        inputs = {"video": _prep_video(cfg, batch["video"]),
                  "text_features": batch.get("text_features")}
        preds, _ = model.apply(inputs, train=False, state_dict=ema)
        mask = batch.get("mask")
        out = {"preds": preds}
        if mask is not None:
            out["num_valid"] = mask.float().sum()
        if isinstance(preds, dict):
            if "label_verb" in batch:
                top1, top5, head_errs = _epic_errors(
                    preds, batch["label_verb"], batch["label_noun"],
                    normalized=head_normalized, weights=mask)
                out.update(top1_err=top1, top5_err=top5, **head_errs)
            return out
        if "labels" in batch:
            c1, c5 = topks_correct(preds, batch["labels"], (1, 5),
                                   weights=mask)
            n = (mask.float().sum().clamp(min=1.0) if mask is not None
                 else preds.shape[0])
            out["top1_err"] = (1.0 - c1 / n) * 100.0
            out["top5_err"] = (1.0 - c5 / n) * 100.0
        return out

    return step


@dataclasses.dataclass
class TrainState:
    """What a train step changes: the model (its module's parameters), the
    optimizer (its moments), the step count and an optional EMA copy of the
    module's ``state_dict``; what a checkpoint will hold."""

    model: Any
    optimizer: torch.optim.Optimizer
    step: int = 0
    ema: Optional[dict] = None


def ema_decay(cfg):
    """``MODEL.EMA.DECAY`` when ``MODEL.EMA.ENABLE``, else None."""
    ema = cfg.MODEL.get("EMA")
    return float(ema.DECAY) if ema and ema.ENABLE else None


def create_train_state(model, optimizer, ema_decay=None):
    """A state at step 0; with ``ema_decay``, a real copy of the module's
    state dict to average into."""
    ema = None
    if ema_decay:
        ema = {k: v.detach().clone()
               for k, v in model.module.state_dict().items()}
    return TrainState(model=model, optimizer=optimizer, ema=ema)


def step_generator(seed, step):
    """A CPU ``torch.Generator`` seeded from (``seed``, ``step``) alone:
    the step's random stream, as the JAX step's ``fold_in(rng, step)``."""
    return torch.Generator().manual_seed(
        hash((int(seed), int(step))) & 0x7FFFFFFFFFFFFFFF)


@contextlib.contextmanager
def step_rng(device, seed, step):
    """torch's default generators (the CPU's and ``device``'s) seeded
    from (``seed``, ``step``, the rank) inside the block and restored
    after it: the model's dropout masks are a function of the step, so
    that a resumed run draws what an uninterrupted one draws."""
    devices = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(hash((int(seed), int(step), collectives.get_rank()))
                          & 0x7FFFFFFFFFFFFFFF)
        yield


_DEVICE_AUG = ("AUGMENTATION.USE_GPU (dist_tpu/ops/augment_device.py) is not "
               "ported yet (ROADMAP.md queue A: SSL/HiCo pretraining, "
               "untrimmed video and the device views)")


def make_train_step(model, cfg, optimizer, lr_fn):
    """The supervised train step.

    ``step(state, batch) -> metrics``, with ``batch`` = {"video": (B, T,
    H, W, 3) uint8 or float, "labels": (B,) int, "text_features":
    optional}, and for EPIC's dual heads "label_verb" and "label_noun"
    (B,) int, all on the model's device. It normalises the video, mixes
    it (not under the verb/noun labels) with draws that are a pure
    function of (``RANDOM_SEED + 1``, ``state.step``), as the JAX step's
    ``fold_in(rng, state.step)``, so
    that a run resumed from a checkpoint draws what an uninterrupted run
    draws; then it runs the forward with ``train=True`` (the module in
    train mode, its BatchNorm on running stats under ``BN.FREEZE``, its
    dropout drawn from :func:`step_rng`) and the loss, back-propagates,
    sets each group's LR from ``lr_fn(state.step)``, steps the
    optimizer, updates the EMA copy and
    returns {"loss", "top1_err", "top5_err", "lr"} as 0-d device tensors
    (the loss parts, if any, beside them). Under the verb/noun labels the
    errors are the joint action errors, with the per-head ones beside
    them (``_epic_errors``); dict predictions without them count 0.
    Each trainable parameter's ``.grad`` holds this step's gradient when
    the optimizer steps (``optimizer.register_step_pre_hook`` reads it
    there); after it, torch's foreach SGD, CUDA's default, has added the
    Nesterov momentum into ``.grad`` in a group without weight decay."""
    if cfg.AUGMENTATION.get("USE_GPU", False):
        raise NotImplementedError(_DEVICE_AUG)
    mixup_on = bool(cfg.AUGMENTATION.MIXUP.ENABLE
                    or cfg.AUGMENTATION.CUTMIX.ENABLE)
    mc = mixup.MixupConfig.from_cfg(cfg) if mixup_on else None
    decay = ema_decay(cfg)
    mix_seed = int(cfg.RANDOM_SEED) + 1
    drop_seed = int(cfg.RANDOM_SEED) + 2
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(state, batch):
        video = _prep_video(cfg, batch["video"])
        epic = "label_verb" in batch
        labels = {"supervised": batch["labels"]}
        if epic:
            # EPIC's dual verb/noun labels: a dict target, whose losses
            # are summed per key; no mixup for it, as in the JAX step
            labels["supervised"] = {"verb_class": batch["label_verb"],
                                    "noun_class": batch["label_noun"]}
        if mc is not None and mc.enabled and not epic:
            d = mixup.draw(mc, step_generator(mix_seed, state.step),
                           video.shape[2], video.shape[3])
            video, labels["supervised_mixup"] = mixup.apply(
                video, batch["labels"], d, mc)
        inputs = {"video": video, "text_features": batch.get("text_features")}
        with step_rng(video.device, drop_seed, state.step):
            preds, logits = model.apply(inputs, train=True)
            loss, parts = calculate_loss(cfg, preds, logits, labels,
                                         cur_epoch=state.step)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        for p in params:
            # a parameter that did not reach the loss (the last ladder
            # step's integration2temporal net) has a zero gradient, as in
            # JAX: Adam's moments and the decay still step. Under DDP it is
            # unused on every rank alike, so every rank steps it the same
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        lr = lr_fn(state.step)
        set_lr(optimizer, lr)
        optimizer.step()

        if decay is not None and state.ema is not None:
            # the running stats are averaged too, as the JAX package's EMA
            # maps over the whole variables tree
            with torch.no_grad():
                for k, v in model.module.state_dict().items():
                    if v.is_floating_point():
                        state.ema[k].mul_(decay).add_(v, alpha=1.0 - decay)

        with torch.no_grad():
            head_errs = {}
            if isinstance(preds, dict):
                preds = {k: v.detach() for k, v in preds.items()}
                if epic:
                    # the joint action errors are the headline ones, the
                    # per-head errors ride beside them
                    top1, top5, head_errs = _epic_errors(
                        preds, batch["label_verb"], batch["label_noun"],
                        normalized=False)
                else:
                    top1 = top5 = torch.zeros((), device=video.device)
            else:
                c1, c5 = topks_correct(preds.detach(), batch["labels"], (1, 5))
                n = preds.shape[0]
                top1, top5 = (1.0 - c1 / n) * 100.0, (1.0 - c5 / n) * 100.0
            metrics = {"loss": loss.detach(), "top1_err": top1,
                       "top5_err": top5,
                       "lr": torch.full((), lr, device=video.device),
                       **head_errs,
                       **{k: v.detach() for k, v in parts.items()}}
        state.step += 1
        return metrics

    return step

