"""Training meters (port of ``ScalarMeter`` and ``TrainMeter`` of
``dist_tpu/utils/meters.py``); ``ValMeter`` and ``TestMeter`` come with the
eval run-list slice. Host-side aggregation of the scalars a train step
returns."""

import datetime
from collections import deque

import numpy as np

from dist_tpu_torch.utils import logging
from dist_tpu_torch.utils.timer import Timer


class ScalarMeter:
    """Windowed scalar meter."""

    def __init__(self, window_size=10):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def reset(self):
        self.deque.clear()
        self.total = 0.0
        self.count = 0

    def add_value(self, value):
        self.deque.append(value)
        self.count += 1
        self.total += value

    def get_win_median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    def get_win_avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    def get_global_avg(self):
        return self.total / max(self.count, 1)


class TrainMeter:
    """Loss / top-k error / lr / ETA tracking over a fold-epoch of
    ``epoch_iters`` steps."""

    def __init__(self, epoch_iters, cfg):
        self.cfg = cfg
        self.epoch_iters = epoch_iters
        # epoch_iters is the fold-epoch length (NUM_FOLDS data epochs per
        # loop pass), so the total divides by NUM_FOLDS
        self.num_folds = int(cfg.TRAIN.get("NUM_FOLDS", 1) or 1)
        self.max_iter = cfg.OPTIMIZER.MAX_EPOCH * epoch_iters / self.num_folds
        self.iter_timer = Timer()
        self.loss = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top1_err = ScalarMeter(cfg.LOG_PERIOD)
        self.mb_top5_err = ScalarMeter(cfg.LOG_PERIOD)
        self.reset()

    def reset(self):
        self.loss.reset()
        self.loss_total = 0.0
        self.lr = None
        self.mb_top1_err.reset()
        self.mb_top5_err.reset()
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.custom = {}

    def iter_tic(self):
        # seconds() reports the last iteration's time; the ETA multiplies
        # it by the iterations left
        self.iter_timer.reset()
        self.iter_timer.tic()

    def iter_toc(self):
        self.iter_timer.toc()

    def update_stats(self, top1_err, top5_err, loss, lr, mb_size):
        self.loss.add_value(loss)
        self.lr = lr
        self.loss_total += loss * mb_size
        self.num_samples += mb_size
        if top1_err is not None:
            self.mb_top1_err.add_value(top1_err)
            self.mb_top5_err.add_value(top5_err)
            self.num_top1_mis += top1_err * mb_size
            self.num_top5_mis += top5_err * mb_size

    def update_custom_stats(self, stats):
        for k, v in stats.items():
            if k not in self.custom:
                self.custom[k] = ScalarMeter(self.cfg.LOG_PERIOD)
            self.custom[k].add_value(float(v))

    def _eta(self, cur_epoch, cur_iter):
        done = cur_epoch * self.epoch_iters / self.num_folds + cur_iter + 1
        secs = self.iter_timer.seconds() * max(self.max_iter - done, 0)
        return str(datetime.timedelta(seconds=int(secs)))

    def log_iter_stats(self, cur_epoch, cur_iter):
        if (cur_iter + 1) % self.cfg.LOG_PERIOD != 0:
            return
        stats = {
            "_type": "train_iter",
            "epoch": f"{cur_epoch + 1}/{self.cfg.OPTIMIZER.MAX_EPOCH}",
            "iter": f"{cur_iter + 1}/{self.epoch_iters}",
            "time_diff": self.iter_timer.seconds(),
            "eta": self._eta(cur_epoch, cur_iter),
            "loss": self.loss.get_win_median(),
            "lr": self.lr,
            "top1_err": self.mb_top1_err.get_win_median(),
            "top5_err": self.mb_top5_err.get_win_median(),
        }
        for k, v in self.custom.items():
            stats[k] = v.get_win_median()
        logging.log_json_stats(stats)

    def log_epoch_stats(self, cur_epoch):
        if self.num_samples == 0:
            return
        stats = {
            "_type": "train_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.OPTIMIZER.MAX_EPOCH}",
            "loss": self.loss_total / self.num_samples,
            "lr": self.lr,
            "top1_err": self.num_top1_mis / self.num_samples,
            "top5_err": self.num_top5_mis / self.num_samples,
        }
        logging.log_json_stats(stats)
