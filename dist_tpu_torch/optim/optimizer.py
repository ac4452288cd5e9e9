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
  momentum, nesterov and dampening (the JAX package's ``_torch_sgd_trace``);
  ``lars`` is :class:`LARS`, the JAX package's ``optax.lars`` chain, with
  the BN group on plain SGD momentum under ``OPTIMIZER.BN_LARS_EXCLUDE``.
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
# the order of the optimizer's parameter groups (an empty one is left
# out): a pipe rank's checkpoint puts its groups in this order
GROUP_ORDER = (TRAINABLE, NO_WD, BODY, BN)



class LARS(torch.optim.Optimizer):
    """Layer-wise adaptive rate scaling as the JAX package chains it:
    ``optax.lars(learning_rate=1.0, weight_decay, momentum, nesterov)``,
    then the group's LR as an outer scale. For each parameter ``w`` with
    gradient ``g``:

    1. ``u = g + weight_decay * w`` (decayed weights);
    2. ``u = u * trust_coefficient * |w| / |u|``, the ratio taken as 1
       where either norm is 0 (optax's ``scale_by_trust_ratio``, eps 0);
    3. the momentum trace ``m = momentum * m + u`` (zeros at the start),
       and the update ``u + momentum * m`` under Nesterov, else ``m``;
    4. ``w -= lr * update``.

    So the trace holds updates before the LR: under a changing LR (warm-up,
    cosine) the step is not torch's "LR then momentum". A group with
    ``lars=False`` (the BN group under ``OPTIMIZER.BN_LARS_EXCLUDE``)
    skips step 2, which leaves plain SGD momentum (optax's
    ``add_decayed_weights`` and ``trace``). The trace is the state's
    ``momentum_buffer``, saved and restored with the optimizer's state
    dict."""

    def __init__(self, params, lr=0.0, weight_decay=0.0, momentum=0.9,
                 nesterov=False, trust_coefficient=0.001, lars=True):
        super().__init__(params, dict(
            lr=lr, weight_decay=weight_decay, momentum=momentum,
            nesterov=nesterov, trust_coefficient=trust_coefficient,
            lars=lars))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            wd, mom = group["weight_decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                u = p.grad.add(p, alpha=wd) if wd else p.grad.clone()
                if group["lars"]:
                    w_norm = torch.linalg.vector_norm(p)
                    u_norm = torch.linalg.vector_norm(u)
                    ratio = group["trust_coefficient"] * w_norm / u_norm
                    ratio = torch.where((w_norm == 0) | (u_norm == 0),
                                        torch.ones_like(ratio), ratio)
                    u.mul_(ratio)
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                buf = state["momentum_buffer"]
                buf.mul_(mom).add_(u)
                update = u.add_(buf, alpha=mom) if group["nesterov"] else buf
                p.add_(update, alpha=-group["lr"])
        return loss



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
    if method not in ("sgd", "adam", "adamw", "lars"):
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
              for k in GROUP_ORDER if members[k]]
    if method == "lars":
        # the BN group skips the trust ratio (the reference's lars_exclude)
        exclude = bool(cfg.OPTIMIZER.get("BN_LARS_EXCLUDE", False))
        for g in groups:
            g["lars"] = not (exclude and g["group"] == BN)
        optimizer = LARS(groups, momentum=float(cfg.OPTIMIZER.MOMENTUM),
                         nesterov=bool(cfg.OPTIMIZER.NESTEROV))
    elif method == "sgd":
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
