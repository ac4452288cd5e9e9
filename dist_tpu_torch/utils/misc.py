"""NaN guard and eval cadence (port of ``check_nan_losses`` and
``is_eval_epoch`` of ``dist_tpu/utils/misc.py``)."""

import math


def check_nan_losses(loss):
    """Abort on a NaN loss."""
    if math.isnan(float(loss)):
        raise RuntimeError("ERROR: Got NaN losses")


def is_eval_epoch(cfg, cur_epoch):
    """Whether to evaluate after the fold-epoch ``cur_epoch``."""
    period = int(cfg.TRAIN.EVAL_PERIOD)
    folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))
    if period == 0:
        return False
    next_epoch = cur_epoch + folds
    return (next_epoch % period < folds) or (
        next_epoch >= cfg.OPTIMIZER.MAX_EPOCH)
