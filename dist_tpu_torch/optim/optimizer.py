"""Optimizer factory with the JAX package's parameter groups (port of
``param_labels`` and ``construct_optimizer`` of
``dist_tpu/optim/optimizer.py``).

- DiST configs: only parameters named ``dist_net`` (or ``head``) train.
  Every other one gets ``requires_grad_(False)`` and no optimizer state,
  as optax's ``set_to_zero`` has none. Names ending in ``cls_token`` or
  ``positional_embedding``, names containing ``embd``/``embed``, biases
  and parameters of at most one dimension get no weight decay.
- Standard configs: ``embd``/``embed``/``cls_token``/
  ``positional_embedding`` without decay; BatchNorm/LayerNorm parameters in
  their own group (``BN.WEIGHT_DECAY``); body parameters at a tenth of the
  LR under ``TRAIN.LR_REDUCE`` + ``FINE_TUNE``; ``TRAIN.FIXED_WEIGHTS``
  name segments, ``BN.WB_LOCK`` and ``TRAIN.ONLY_LINEAR`` freeze.
- ``adam`` and ``adamw`` are both ``torch.optim.AdamW`` (decoupled decay,
  eps 1e-8), as the JAX package chains ``scale_by_adam`` and
  ``add_decayed_weights`` for both; ``sgd`` is ``torch.optim.SGD`` with
  momentum, nesterov and dampening (the JAX package's ``_torch_sgd_trace``).
- Each group carries ``lr_mult``; the train step sets every group's
  ``lr = lr_fn(step) * lr_mult`` before ``optimizer.step()``.

A model with a JAX counterpart table (the conv family's
``BaseVideoModel``, ``models/backbones/convert.py::jax_table``) is
labelled by each parameter's JAX name, so that both packages put every
parameter in the same group: the JAX ``ConvBN`` calls its BatchNorm
``bn`` (the BN group) where the reference's name is ``a_bn``, while the
TAda block's own ``a_bn``, ``b_bn`` ... keep their names in both (not the
BN group: decayed like any weight).

One difference from the JAX package is kept on purpose: it stacks the
ladder's per-step parameters on a leading axis, so the ladder's LayerNorm
scales reach its "ndim <= 1" rule as 2-D and are decayed. The port holds
each step's parameters apart, so they are 1-D and get no decay, which is
the rule of the reference's ``construct_DiST_optimizer``.
"""

import torch

from dist_tpu_torch.optim.lr_policy import lr_schedule_by_step
from dist_tpu_torch.parallel import collectives
from dist_tpu_torch.parallel.mesh import data_axis_size

TRAINABLE = "trainable"
NO_WD = "trainable_no_wd"   # cls tokens / positional embeddings / 1-D params
FROZEN = "frozen"
BODY = "body_reduced"       # non-head params under TRAIN.LR_REDUCE+FINE_TUNE
BN = "bn_group"             # bn/norm params (BN.WEIGHT_DECAY, lr_reduce)
REDUCE_SCALE = 0.1

_LARS = ("LARS is not ported yet: the PyTorch port has no layer-wise "
         "trust-ratio optimizer (ROADMAP.md queue A: SSL/HiCo "
         "pretraining)")


def _segments(name):
    return name.replace("/", ".").split(".")


def _is_bn_param(name):
    return any(seg.startswith("bn") or "norm" in seg
               for seg in _segments(name))


def _dist_enabled(cfg):
    return bool(cfg.VIDEO.BACKBONE.get("DIST")
                and cfg.VIDEO.BACKBONE.DIST.ENABLE)


def _is_text_param(module, name):
    test = getattr(module, "is_text_param", None)
    return bool(test and test(name))


def _rule_names(module):
    """{parameter name: the name the grouping rules read}: the JAX name
    where the module has a counterpart table, else its own."""
    from dist_tpu_torch.models.base.models import BaseVideoModel

    if isinstance(module, BaseVideoModel):
        from dist_tpu_torch.models.backbones.convert import jax_param_names
        return jax_param_names(module)
    return {name: name for name, _ in module.named_parameters()}


def param_labels(cfg, module):
    """{parameter name: group} for every parameter of ``module``."""
    dist_enabled = _dist_enabled(cfg)
    only_linear = bool(cfg.TRAIN.get("ONLY_LINEAR", False))
    freeze_visual = bool(cfg.VIDEO.BACKBONE.get("FREEZE_VISUAL", False))
    freeze_text = bool(cfg.VIDEO.BACKBONE.get("FREEZE_TEXT", False))
    wb_lock = bool(cfg.BN.get("WB_LOCK", False))
    lr_reduce = bool(cfg.TRAIN.get("LR_REDUCE", False)
                     and cfg.TRAIN.get("FINE_TUNE", False))
    fixed = tuple(cfg.TRAIN.get("FIXED_WEIGHTS", ()) or ())
    standard = not dist_enabled and not only_linear

    def label(name, p):
        if fixed and any(seg in fixed for seg in _segments(name)):
            return FROZEN
        if wb_lock and _is_bn_param(name):
            return FROZEN
        if only_linear:
            trainable = "head" in name
        elif dist_enabled:
            trainable = "dist_net" in name or "head" in name
        else:
            trainable = True
            if freeze_visual and name.startswith("visual."):
                trainable = False
            if freeze_text and (_is_text_param(module, name)
                                or name == "logit_scale"):
                trainable = False
        if not trainable:
            return FROZEN
        no_wd = (name.endswith("cls_token")
                 or name.endswith("positional_embedding")
                 or "embd" in name or "embed" in name)
        if not standard:
            no_wd = no_wd or name.endswith("bias") or p.dim() <= 1
        if no_wd:
            return NO_WD
        if standard and _is_bn_param(name):
            return BN
        if standard and lr_reduce and "head" not in name:
            return BODY
        return TRAINABLE

    names = _rule_names(module)
    return {name: label(names[name], p)
            for name, p in module.named_parameters()}


def base_lr(cfg):
    """BASE_LR, scaled linearly by the global batch under
    ``OPTIMIZER.ADJUST_LR``: ``TRAIN.BATCH_SIZE`` is per rank, so the
    global batch is that times the data axis (the world)."""
    lr = float(cfg.OPTIMIZER.BASE_LR)
    if cfg.OPTIMIZER.get("ADJUST_LR", False):
        n_clips = (cfg.PRETRAIN.get("NUM_CLIPS_PER_VIDEO", 1)
                   if cfg.PRETRAIN.ENABLE else 1)
        data = data_axis_size(cfg, collectives.get_world_size())
        lr = lr * data * cfg.TRAIN.BATCH_SIZE * n_clips / 256.0
    return lr


def construct_optimizer(cfg, module, steps_per_epoch, start_epoch=0):
    """(optimizer, lr_fn): the optimizer over ``module``'s trainable
    parameters (the frozen ones get ``requires_grad_(False)``), and
    ``lr_fn(step)``, the schedule's LR before the groups' ``lr_mult``."""
    method = cfg.OPTIMIZER.OPTIM_METHOD
    if method == "lars":
        raise NotImplementedError(_LARS)
    if method not in ("sgd", "adam", "adamw"):
        raise NotImplementedError(f"Unsupported optimizer {method}")
    dist_enabled = _dist_enabled(cfg)
    lr_mult = (float(cfg.OPTIMIZER.get("NEW_NET_LRMULT", 1.0))
               if dist_enabled else 1.0)
    wd = float(cfg.OPTIMIZER.get("NEW_NET_WEIGHT_DECAY",
                                 cfg.OPTIMIZER.WEIGHT_DECAY)
               if dist_enabled else cfg.OPTIMIZER.WEIGHT_DECAY)
    reduce = bool(cfg.TRAIN.get("LR_REDUCE", False)
                  and cfg.TRAIN.get("FINE_TUNE", False))
    group_opts = {
        TRAINABLE: (wd, 1.0),
        NO_WD: (0.0, 1.0),
        BODY: (wd, REDUCE_SCALE),
        BN: (float(cfg.BN.get("WEIGHT_DECAY", 0.0) or 0.0),
             REDUCE_SCALE if reduce else 1.0),
    }
    labels = param_labels(cfg, module)
    members = {k: [] for k in group_opts}
    for name, p in module.named_parameters():
        if labels[name] == FROZEN:
            p.requires_grad_(False)
        else:
            p.requires_grad_(True)
            members[labels[name]].append(p)
    groups = [{"params": members[k], "weight_decay": group_opts[k][0],
               "lr_mult": lr_mult * group_opts[k][1], "group": k}
              for k in group_opts if members[k]]
    if method == "sgd":
        optimizer = torch.optim.SGD(
            groups, lr=0.0, momentum=float(cfg.OPTIMIZER.MOMENTUM),
            dampening=float(cfg.OPTIMIZER.get("DAMPENING", 0.0) or 0.0),
            nesterov=bool(cfg.OPTIMIZER.NESTEROV))
    else:
        betas = tuple(float(b) for b in cfg.OPTIMIZER.get("BETAS",
                                                          [0.9, 0.999]))
        optimizer = torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=1e-8)

    schedule = lr_schedule_by_step(cfg, steps_per_epoch, start_epoch)
    lr0, scale_base = base_lr(cfg), float(cfg.OPTIMIZER.BASE_LR)

    def lr_fn(step):
        s = schedule(step)
        # the schedule is built on BASE_LR; rescale if ADJUST_LR changed it
        return s * (lr0 / scale_base) if scale_base else s

    return optimizer, lr_fn


def set_lr(optimizer, lr):
    """Every group's LR for this step: ``lr`` times the group's
    ``lr_mult``."""
    for group in optimizer.param_groups:
        group["lr"] = lr * group["lr_mult"]
