"""Learning-rate policies (port of ``dist_tpu/optim/lr_policy.py``).

Functions of a fractional epoch, in Python floats; the train step
evaluates them at ``start + NUM_FOLDS * step / steps_per_epoch``."""

import math


def lr_func_cosine(cfg, cur_epoch):
    base = float(cfg.OPTIMIZER.BASE_LR)
    max_epoch = float(cfg.OPTIMIZER.MAX_EPOCH)
    return base * (math.cos(math.pi * cur_epoch / max_epoch) + 1.0) * 0.5


def lr_func_steps_with_relative_lrs(cfg, cur_epoch):
    steps = list(cfg.OPTIMIZER.get("STEPS", None)
                 or cfg.OPTIMIZER.get("LR_MILESTONES", []))
    lrs = list(cfg.OPTIMIZER.LRS)
    bounds = steps + [float(cfg.OPTIMIZER.MAX_EPOCH)]
    # STEPS lead with 0: the stage is the count of crossed bounds less one
    ind = sum(cur_epoch >= b for b in bounds)
    ind = min(max(ind - 1, 0), len(lrs) - 1)
    return lrs[ind] * float(cfg.OPTIMIZER.BASE_LR)


_POLICIES = {
    "cosine": lr_func_cosine,
    "steps_with_relative_lrs": lr_func_steps_with_relative_lrs,
}


def get_lr_at_epoch(cfg, cur_epoch):
    """The policy's value with linear warmup from WARMUP_START_LR."""
    policy = cfg.OPTIMIZER.LR_POLICY
    if policy not in _POLICIES:
        raise NotImplementedError(f"Unknown LR policy: {policy}")
    fn = _POLICIES[policy]
    lr = fn(cfg, cur_epoch)
    warmup = float(cfg.OPTIMIZER.WARMUP_EPOCHS)
    if warmup > 0 and cur_epoch < warmup:
        lr_start = float(cfg.OPTIMIZER.WARMUP_START_LR)
        alpha = (fn(cfg, warmup) - lr_start) / warmup
        lr = cur_epoch * alpha + lr_start
    return float(lr)


def lr_schedule_by_step(cfg, steps_per_epoch, start_epoch=0, num_folds=None):
    """step -> lr at the fractional epoch
    ``start_epoch + num_folds * step / steps_per_epoch``."""
    if num_folds is None:
        num_folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))

    def schedule(count):
        cur_epoch = start_epoch + num_folds * count / float(steps_per_epoch)
        return get_lr_at_epoch(cfg, cur_epoch)

    return schedule
