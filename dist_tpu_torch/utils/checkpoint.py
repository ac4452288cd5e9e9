"""Checkpoint loading for evaluation and serving: the torch-checkpoint side
of ``dist_tpu/utils/checkpoint.py::load_test_checkpoint``.

Orbax checkpoints written by the JAX package (directories under
``OUTPUT_DIR/checkpoints``) are not read by the port, which cannot import
``orbax``; meeting one is an error that says how to convert it, never a
silent random model. A JAX-trained tree reaches the port through
``models/clip/convert.py::state_dict_from_jax`` and a ``.pyth`` file.
"""

import os
import pickle
import re

import torch

from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ORBAX_TODO = ("the port does not read the JAX package's Orbax checkpoints "
               "(ROADMAP.md queue A, item 2.1: checkpoints); restore the "
               "JAX TrainState, convert its params with "
               "dist_tpu_torch.models.clip.convert.state_dict_from_jax, "
               "torch.save them as a .pyth and point "
               "TEST.CHECKPOINT_FILE_PATH at it")


def _is_torch_ckpt(path):
    return path.endswith((".pyth", ".pt", ".pth"))


def get_last_checkpoint(cfg):
    """Latest ``checkpoint_epoch_*`` entry under OUTPUT_DIR/checkpoints, or
    None."""
    d = os.path.join(cfg.OUTPUT_DIR, "checkpoints")
    if not os.path.isdir(d):
        return None
    names = sorted(n for n in os.listdir(d)
                   if re.match(r"checkpoint_epoch_\d+(_iter_\d+)?$", n))
    return os.path.abspath(os.path.join(d, names[-1])) if names else None


def load_torch_weights(model, path):
    """Load a torch checkpoint into ``model.module`` where names and shapes
    match (the reference's ``load_state_dict(strict=False)``); logs what
    did not match."""
    from dist_tpu_torch.models.clip.convert import load_torch_state_dict

    sd = load_torch_state_dict(path)
    own = model.module.state_dict()
    take = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    missing = sorted(set(own) - set(take))
    unexpected = sorted(set(sd) - set(take))
    model.module.load_state_dict(take, strict=False)
    if missing:
        logger.info("Keys in model not matched: %s", missing[:20])
    if unexpected:
        logger.info("Keys in checkpoint not matched: %s", unexpected[:20])
    return model


def load_test_checkpoint(cfg, model):
    """Priority TEST.CHECKPOINT_FILE_PATH > last checkpoint >
    TRAIN.CHECKPOINT_FILE_PATH; random weights when none is configured."""
    for path in (cfg.TEST.CHECKPOINT_FILE_PATH, get_last_checkpoint(cfg),
                 cfg.TRAIN.CHECKPOINT_FILE_PATH):
        if not path:
            continue
        if not _is_torch_ckpt(path):
            raise NotImplementedError(f"{path}: {_ORBAX_TODO}")
        try:
            load_torch_weights(model, path)
        except (OSError, RuntimeError, pickle.UnpicklingError) as e:
            # a corrupt or mismatched file falls through to the next one
            logger.warning("could not load torch checkpoint %s (%s)", path, e)
            continue
        logger.info("Loaded test checkpoint %s", path)
        return model
    logger.warning("Testing with random initialization (no checkpoint found).")
    return model
