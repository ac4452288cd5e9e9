"""NaN guard, eval cadence and parameter count (port of
``check_nan_losses``, ``is_eval_epoch``, ``params_count`` and
``log_model_info`` of ``dist_tpu/utils/misc.py``)."""

import math

from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


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


def params_count(module):
    """Number of parameters of an ``nn.Module``."""
    return sum(int(p.numel()) for p in module.parameters())


def log_model_info(module):
    """Log the parameter count. FLOPs come with the train run (the JAX
    package takes them from XLA's cost analysis; ROADMAP.md queue A,
    item 2)."""
    n = params_count(module)
    logger.info("Params: {:,}".format(n))
    return n
