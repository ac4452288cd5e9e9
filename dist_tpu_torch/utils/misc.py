"""NaN guard, eval cadence, parameter and FLOP counts (port of
``check_nan_losses``, ``is_eval_epoch``, ``params_count``,
``flops_count`` and ``log_model_info`` of ``dist_tpu/utils/misc.py``)."""

import math

import torch

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


def flops_count(fn, *args):
    """FLOPs of one call ``fn(*args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (2 per multiply-add of a
    matrix product or convolution; the JAX package reads XLA's cost
    analysis). ``nan``, with a warning, where counting fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            fn(*args)
        return float(counter.get_total_flops())
    except Exception as e:  # counting is best-effort, as in the JAX package
        logger.warning("flop counting failed: %s", e)
        return float("nan")


def log_model_info(module):
    """Log the parameter count."""
    n = params_count(module)
    logger.info("Params: {:,}".format(n))
    return n
