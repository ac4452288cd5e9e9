"""The train loop's epoch (port of ``train_epoch`` of
``dist_tpu/tasks/train.py``). Preemption, multi-host polling, checkpoint
save and resume, and ``train(cfg)`` come with the train run (ROADMAP.md
queue A, item 2)."""

import torch

from dist_tpu_torch.tasks.state import to_device
from dist_tpu_torch.utils import misc


def train_epoch(cfg, state, train_step, loader, meter, cur_epoch, generator,
                text_features=None):
    """One fold-epoch over ``loader``, any iterable of host batches
    {"video": uint8 (B, T, H, W, 3), "label": int (B,)} (numpy arrays or
    CPU tensors). Each batch goes to the model's device and through
    ``train_step``; the metrics of step k are read back while step k + 1
    runs on the card (a lag of one step), checked for a NaN loss and fed
    to ``meter`` (a ``TrainMeter``), which logs them. Returns ``state``."""
    device = state.model.device
    meter.iter_tic()

    def consume(metrics, cur_iter, mb_size):
        values = {k: float(v) for k, v in metrics.items()}
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

    pending = None
    for cur_iter, batch in enumerate(loader):
        device_batch = {"video": to_device(batch["video"], device),
                        "labels": to_device(batch["label"], device,
                                            torch.long)}
        if text_features is not None:
            device_batch["text_features"] = text_features
        metrics = train_step(state, device_batch, generator)
        if pending is not None:
            consume(*pending)
        pending = (metrics, cur_iter, int(device_batch["labels"].shape[0]))
    if pending is not None:
        consume(*pending)
    meter.log_epoch_stats(cur_epoch + int(cfg.TRAIN.get("NUM_FOLDS", 1)) - 1)
    meter.reset()
    return state
