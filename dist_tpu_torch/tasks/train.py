"""Training task loop (port of ``dist_tpu/tasks/train.py``).

``train(cfg)`` builds the model, the loaders and the optimizer, resumes or
fine-tunes from a checkpoint, and runs fold-epochs of ``NUM_FOLDS`` data
epochs with the reference's shuffle, checkpoint and eval cadence. Each
step is ``tasks/state.py::make_train_step``'s eager step on the card; the
host reads a step's metrics back while the next runs (a lag of one step).

Data parallel: inside a ``torch.distributed`` group (``parallel/``) each
rank trains on its own shard of every global batch, the forward goes
through ``DistributedDataParallel`` (its backward all-reduces the
gradients), the meters log the mean over the ranks, rank 0 writes the
checkpoints and every rank reads them.

Preemption: SIGTERM, or the ``TRAIN.PREEMPT_AFTER_ITERS`` fault
injection, makes the loop drain the step in flight, write a mid-epoch
checkpoint carrying (epoch, iter) and exit through ``SystemExit(0)``. A
resume skips exactly the consumed prefix of the deterministic batch
stream, and the step's random draws are a function of its step count, so
the resumed run equals an uninterrupted one. Ranks receive SIGTERM at
different moments, so at a world above one the loops act only on the
flag the ranks agree on (``collectives.any_flag``), polled every
``TRAIN.PREEMPT_SYNC_PERIOD`` steps: every rank stops at the same
iteration.
"""

import signal
import threading
import time

import numpy as np
import torch

from dist_tpu_torch.data.builder import build_loader, shuffle_dataset
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.parallel import collectives
from dist_tpu_torch.parallel.mesh import prepare_model, wrap_ddp
from dist_tpu_torch.tasks.state import (
    compute_text_features,
    create_train_state,
    ema_decay,
    load_pretrained,
    make_eval_step,
    make_train_step,
    to_device,
)
from dist_tpu_torch.utils import checkpoint as cu
from dist_tpu_torch.utils import logging, misc
from dist_tpu_torch.utils.device import resolve_device
from dist_tpu_torch.utils.meters import TrainMeter, ValMeter

logger = logging.get_logger(__name__)

# Preemption flag: set by SIGTERM or by the TRAIN.PREEMPT_AFTER_ITERS fault
# injection; the loops poll it at step boundaries.
_PREEMPTED = threading.Event()

# tells "handler never installed" apart from a previous disposition of None
# (signal.signal returns None for a handler installed outside Python)
_HANDLER_NOT_INSTALLED = object()


def _install_preemption_handler():
    """Returns the previous SIGTERM disposition, to restore after the loop
    (left installed, the flag-setting handler would swallow SIGTERM in the
    test entries that follow), or ``_HANDLER_NOT_INSTALLED`` off the main
    thread."""
    def _on_sigterm(signum, frame):
        logger.info("SIGTERM: will checkpoint at the next step boundary.")
        _PREEMPTED.set()

    try:
        return signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        logger.info("Not installing SIGTERM handler (non-main thread).")
        return _HANDLER_NOT_INSTALLED


def _sync_period(cfg):
    return max(1, int(cfg.TRAIN.get("PREEMPT_SYNC_PERIOD", 10) or 1))


def _agreed_preempted(cfg):
    """The flag the ranks agree on (every rank must call in at the same
    point), gated on ``TRAIN.SAVE_ON_PREEMPTION``."""
    if not bool(cfg.TRAIN.get("SAVE_ON_PREEMPTION", True)):
        return False
    return collectives.any_flag(_PREEMPTED.is_set())


def _poll_stop(cfg, boundary_iter):
    """The stop flag the train and eval loops act on after iteration
    ``boundary_iter``, gated on ``TRAIN.SAVE_ON_PREEMPTION``: one process
    acts on its own flag; at a world above one, only the agreed flag
    counts, polled at every ``TRAIN.PREEMPT_SYNC_PERIOD``-th boundary."""
    if not bool(cfg.TRAIN.get("SAVE_ON_PREEMPTION", True)):
        return False
    if collectives.get_world_size() > 1:
        if (boundary_iter + 1) % _sync_period(cfg):
            return False
        return _agreed_preempted(cfg)
    return _PREEMPTED.is_set()


def _global_mean(values, weight):
    """(the data shards' mean of each of ``values``, each shard weighted
    by ``weight``; the total weight). One shard: as given."""
    world = collectives.data_size()
    if world == 1:
        return values, weight
    keys = sorted(values)
    means = collectives.all_reduce_mean(
        weight, *(values[k] * weight for k in keys))
    total = means[0] * world
    return ({k: m / means[0] if means[0] else 0.0
             for k, m in zip(keys, means[1:])}, total)


def train(cfg, device=None):
    """Train on ``device`` (default: the CUDA card, ``cuda:LOCAL_RANK``
    in a group; raises without one unless ``device="cpu"``). Returns the
    final ``TrainState``; a preemption exits through ``SystemExit(0)``
    after its checkpoint, on every rank at the same iteration."""
    device = resolve_device(device)
    np.random.seed(int(cfg.RANDOM_SEED))
    logging.setup_logging(cfg, cfg.TRAIN.LOG_FILE)
    logger.info("Train with config:\n%s",
                cfg.dump() if cfg.LOG_CONFIG_INFO else "")

    model = build_model(cfg, device=device)
    load_pretrained(cfg, model)
    # the model axis's slices, the pipe stage or FSDP's shards: before the
    # optimizer, which must step the tensors the module reads
    prepare_model(model)
    train_loader = build_loader(cfg, "train", device=device)
    val_loader = build_loader(cfg, "val", device=device)
    try:
        # the schedule divides by the FULL fold-epoch length (it multiplies
        # by NUM_FOLDS itself)
        steps_per_epoch = max(len(train_loader), 1)
        optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                               steps_per_epoch)
        state = create_train_state(model, optimizer, ema_decay(cfg))
        if cfg.LOG_MODEL_INFO:
            misc.log_model_info(model.module)
        state, start_epoch, start_iter = cu.load_train_checkpoint(
            cfg, state, dataset_len=len(train_loader.dataset))
        if start_iter and start_iter >= len(train_loader):
            # a mid-epoch checkpoint at or past the epoch's length (the save
            # path writes an end-of-epoch one instead): the fold-epoch is done
            logger.warning("Mid-epoch checkpoint iter %d >= epoch length %d; "
                           "resuming at the next fold-epoch.", start_iter,
                           len(train_loader))
            start_epoch += int(cfg.TRAIN.get("NUM_FOLDS", 1))
            start_iter = 0
        if torch.distributed.is_initialized():
            wrap_ddp(model)
        text_features = compute_text_features(
            model, getattr(train_loader.dataset, "text_tokens", None))
        num_folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))
        if (cfg.OPTIMIZER.MAX_EPOCH - start_epoch) % num_folds:
            raise ValueError(
                f"remaining epochs ({cfg.OPTIMIZER.MAX_EPOCH} - {start_epoch}) "
                f"must be divisible by TRAIN.NUM_FOLDS={num_folds}")
        train_step = make_train_step(model, cfg, optimizer, lr_fn)
        eval_step = make_eval_step(model, cfg)
        ema_eval_step = (make_eval_step(model, cfg, use_ema=True)
                         if state.ema is not None else None)
        train_meter = TrainMeter(len(train_loader), cfg)
        val_meter = ValMeter(len(val_loader), cfg)
        run_iters = [0]   # the TRAIN.PREEMPT_AFTER_ITERS counter
        if start_iter:
            logger.info("Mid-epoch resume: fold-epoch %d from iter %d",
                        start_epoch, start_iter)
            train_loader.set_skip_batches(start_iter)

        _PREEMPTED.clear()
        prev_sigterm = _HANDLER_NOT_INSTALLED
        if bool(cfg.TRAIN.get("SAVE_ON_PREEMPTION", True)):
            prev_sigterm = _install_preemption_handler()
        try:
            _run_epochs(cfg, state, train_step, eval_step, ema_eval_step,
                        train_loader, val_loader, train_meter, val_meter,
                        text_features, start_epoch, start_iter, num_folds,
                        run_iters)
        finally:
            if prev_sigterm is not _HANDLER_NOT_INSTALLED:
                # after training a SIGTERM ends the process again; None
                # means "installed outside Python": SIG_DFL is closest
                signal.signal(signal.SIGTERM,
                              prev_sigterm if prev_sigterm is not None
                              else signal.SIG_DFL)
    finally:
        train_loader.close()
        val_loader.close()
    cu.wait_until_finished()   # join an in-flight async checkpoint commit
    return state


def _run_epochs(cfg, state, train_step, eval_step, ema_eval_step,
                train_loader, val_loader, train_meter, val_meter,
                text_features, start_epoch, start_iter, num_folds, run_iters):
    """The fold-epoch loop, apart from ``train`` so that the SIGTERM
    disposition is restored however it ends."""
    for cur_epoch in range(start_epoch, cfg.OPTIMIZER.MAX_EPOCH, num_folds):
        shuffle_dataset(train_loader, cur_epoch)
        if hasattr(train_loader.dataset, "set_epoch_rate"):
            # curriculum progress, passed explicitly
            train_loader.dataset.set_epoch_rate(
                cur_epoch / max(float(cfg.OPTIMIZER.MAX_EPOCH), 1.0))
        iter_offset = start_iter if cur_epoch == start_epoch else 0
        state, preempt_iter = train_epoch(
            cfg, state, train_step, train_loader, train_meter, cur_epoch,
            text_features, iter_offset, run_iters)
        if preempt_iter is not None:
            if preempt_iter >= len(train_loader):
                # caught at the final step: the fold-epoch is consumed, so
                # an end-of-epoch checkpoint (a mid-epoch one with iter ==
                # the epoch's length would fail every resume's skip)
                cu.save_checkpoint(cfg, state, cur_epoch)
            else:
                cu.save_checkpoint(
                    cfg, state, cur_epoch, iter_in_epoch=preempt_iter,
                    dataset_len=len(train_loader.dataset))
            cu.wait_until_finished()
            logger.info("Preemption checkpoint committed (fold-epoch %d, "
                        "iter %d); exiting.", cur_epoch, preempt_iter)
            raise SystemExit(0)

        def _exit_preempted(saved):
            # a SIGTERM outside the step loop (epoch tail, save, eval) still
            # exits promptly with a durable end-of-epoch checkpoint
            if not saved:
                cu.save_checkpoint(cfg, state, cur_epoch)
            cu.wait_until_finished()
            logger.info("Preemption at the fold-epoch %d boundary; "
                        "checkpoint committed, exiting.", cur_epoch)
            raise SystemExit(0)

        saved = False
        if cu.is_checkpoint_epoch(cfg, cur_epoch):
            cu.save_checkpoint(cfg, state, cur_epoch)
            saved = True
        if _agreed_preempted(cfg):
            _exit_preempted(saved)
        if misc.is_eval_epoch(cfg, cur_epoch):
            eval_epoch(cfg, state, eval_step, val_loader, val_meter,
                       cur_epoch, text_features)
            if ema_eval_step is not None:
                logger.info("Evaluating EMA model.")
                eval_epoch(cfg, state, ema_eval_step, val_loader, val_meter,
                           cur_epoch, text_features)
            if _agreed_preempted(cfg):
                _exit_preempted(saved)


def train_epoch(cfg, state, train_step, loader, meter, cur_epoch,
                text_features=None, iter_offset=0, run_iters=None):
    """One fold-epoch over ``loader``, any iterable of host batches
    {"video": uint8 (B, T, H, W, 3), "label": int (B,)} (numpy arrays or
    CPU tensors). Each batch goes to the model's device and through
    ``train_step``; the metrics of step k are read back while step k + 1
    runs on the card, checked for a NaN loss and fed to ``meter`` (a
    ``TrainMeter``), which logs them under the in-epoch iter
    ``iter_offset + k``: in a group, their mean over the ranks, each step
    counted as the global batch. Appends the loop's timing to
    ``meter.timing``: its batches, seconds, seconds waiting on the loader,
    and each step's seconds and wait (``iter_s``, ``wait_s``).

    Returns ``(state, preempt_iter)``: ``preempt_iter`` is None for a
    completed epoch, else the batches of this fold-epoch consumed so far
    (the resumed prefix included), which the caller checkpoints.
    ``run_iters`` counts steps across epochs for the fault injection
    ``TRAIN.PREEMPT_AFTER_ITERS`` (N >= 0 fires once N steps have run, so
    0 and 1 both fire after the first step; -1 never)."""
    raw = cfg.TRAIN.get("PREEMPT_AFTER_ITERS", -1)
    preempt_after = -1 if raw is None else int(raw)
    device = state.model.device
    timing = {"batches": 0, "loader_wait_s": 0.0, "iter_s": [], "wait_s": []}
    meter.timing.append(timing)
    meter.iter_tic()

    def consume(metrics, cur_iter, mb_size):
        values, _ = _global_mean({k: float(v) for k, v in metrics.items()},
                                 1.0)
        mb_size *= collectives.data_size()
        misc.check_nan_losses(values["loss"])
        meter.iter_toc()
        meter.update_stats(values["top1_err"], values["top5_err"],
                           values["loss"], values["lr"], mb_size)
        extra = {k: v for k, v in values.items()
                 if k not in ("loss", "top1_err", "top5_err", "lr")}
        if extra:
            meter.update_custom_stats(extra)
        meter.log_iter_stats(cur_epoch, cur_iter)
        meter.iter_tic()

    def batches():
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            wait = time.perf_counter() - t0
            timing["loader_wait_s"] += wait
            if batch is None:
                return
            timing["wait_s"].append(wait)
            yield batch

    pending = None
    start = last = time.perf_counter()
    try:
        for cur_iter, batch in enumerate(batches()):
            device_batch = {"video": to_device(batch["video"], device),
                            "labels": to_device(batch["label"], device,
                                                torch.long)}
            for key in ("label_verb", "label_noun", "contrastive"):
                if key in batch:
                    # the rank's rows, as its video
                    device_batch[key] = to_device(batch[key], device,
                                                  torch.long)
            if text_features is not None:
                device_batch["text_features"] = text_features
            metrics = train_step(state, device_batch)
            if pending is not None:
                consume(*pending)
            pending = (metrics, iter_offset + cur_iter,
                       int(device_batch["labels"].shape[0]))
            now = time.perf_counter()
            timing["iter_s"].append(now - last)
            timing["batches"] += 1
            last = now
            if run_iters is not None:
                run_iters[0] += 1
                if 0 <= preempt_after <= run_iters[0]:
                    _PREEMPTED.set()      # fault injection: a SIGTERM
            if _poll_stop(cfg, cur_iter):
                consume(*pending)
                return state, iter_offset + cur_iter + 1
        if pending is not None:
            consume(*pending)
    finally:
        timing["loop_s"] = time.perf_counter() - start
    if iter_offset:
        logger.info("fold-epoch %d summary below covers iters %d+ only "
                    "(mid-epoch resume)", cur_epoch, iter_offset)
    meter.log_epoch_stats(cur_epoch + int(cfg.TRAIN.get("NUM_FOLDS", 1)) - 1)
    meter.reset()
    return state, None


def eval_epoch(cfg, state, eval_step, loader, meter, cur_epoch,
               text_features):
    """Evaluate on ``loader`` into ``meter`` (a ``ValMeter``), lag 1 like
    the train loop. The step's errors are means over the batch's valid
    rows (the loader's pad mask), so each batch is weighted by its valid
    count, in a group the count over every rank. Returns the epoch's
    stats, or None when a preemption aborted the epoch (its results are
    recomputable; the caller checkpoints)."""
    meter.reset()
    device = state.model.device

    def consume(metrics, mb):
        values = {k: float(v) for k, v in metrics.items() if k != "preds"}
        nv = values.pop("num_valid", None)
        if nv is not None:
            mb = nv
        values, mb = _global_mean(values, mb)
        if mb <= 0:
            return    # a batch of pad duplicates only
        meter.update_stats(values["top1_err"], values["top5_err"], mb)
        extra = {k: v for k, v in values.items()
                 if k not in ("top1_err", "top5_err")}
        if extra:
            meter.update_custom_stats(extra, mb_size=mb)

    pending = None
    for cur_iter, batch in enumerate(loader):
        if _poll_stop(cfg, cur_iter):
            logger.info("Preemption: aborting eval at iter %d.", cur_iter)
            return None
        device_batch = {"video": to_device(batch["video"], device),
                        "labels": to_device(batch["label"], device,
                                            torch.long)}
        if "_mask" in batch:
            device_batch["mask"] = to_device(batch["_mask"], device)
        for key in ("label_verb", "label_noun"):
            if key in batch:
                device_batch[key] = to_device(batch[key], device, torch.long)
        if text_features is not None:
            device_batch["text_features"] = text_features
        metrics = eval_step(device_batch, state)
        if pending is not None:
            consume(*pending)
        pending = (metrics, batch["video"].shape[0])
    if pending is not None:
        consume(*pending)
    return meter.log_epoch_stats(cur_epoch)
