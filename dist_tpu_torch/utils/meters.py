"""Meters (port of ``ScalarMeter``, ``TrainMeter``, ``ValMeter``,
``TestMeter`` and ``EpicKitchenMeter`` of ``dist_tpu/utils/meters.py``).
Host-side aggregation, in numpy, of what the train and eval steps
return."""

import datetime
from collections import deque

import numpy as np

from dist_tpu_torch.utils import logging
from dist_tpu_torch.utils.timer import Timer

logger = logging.get_logger(__name__)


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
    ``epoch_iters`` steps.

    ``timing`` holds one record per fold-epoch that the train loop ran
    (``tasks/train.py::train_epoch``): its batches, its loop seconds, the
    seconds blocked on the loader and each iteration's host seconds;
    ``reset`` leaves it."""

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
        self.timing = []
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


class ValMeter:
    """Eval-during-train meter: top-k errors weighted by each batch's
    valid count, their minimum over the run's eval epochs, and custom
    scalars weighted the same way."""

    def __init__(self, max_iter, cfg):
        self.cfg = cfg
        self.max_iter = max_iter
        self.min_top1_err = 100.0
        self.min_top5_err = 100.0
        self.reset()

    def reset(self):
        self.num_top1_mis = 0
        self.num_top5_mis = 0
        self.num_samples = 0
        self.custom_sums = {}
        self.custom_counts = {}

    def update_stats(self, top1_err, top5_err, mb_size):
        self.num_top1_mis += top1_err * mb_size
        self.num_top5_mis += top5_err * mb_size
        self.num_samples += mb_size

    def update_custom_stats(self, stats, mb_size=1):
        """Custom scalars (EPIC's per-head errors), each batch weighted by
        ``mb_size`` as the headline errors are."""
        for k, v in stats.items():
            self.custom_sums[k] = self.custom_sums.get(k, 0.0) + float(v) * mb_size
            self.custom_counts[k] = self.custom_counts.get(k, 0) + mb_size

    def log_epoch_stats(self, cur_epoch):
        """Log and return the epoch's stats ({} when nothing was seen)."""
        if self.num_samples == 0:
            return {}
        top1_err = self.num_top1_mis / self.num_samples
        top5_err = self.num_top5_mis / self.num_samples
        self.min_top1_err = min(self.min_top1_err, top1_err)
        self.min_top5_err = min(self.min_top5_err, top5_err)
        stats = {
            "_type": "val_epoch",
            "epoch": f"{cur_epoch + 1}/{self.cfg.OPTIMIZER.MAX_EPOCH}",
            "top1_err": top1_err,
            "top5_err": top5_err,
            "min_top1_err": self.min_top1_err,
            "min_top5_err": self.min_top5_err,
        }
        for k, s in self.custom_sums.items():
            stats[k] = s / max(self.custom_counts[k], 1)
        logging.log_json_stats(stats)
        return stats


class EpicKitchenMeter:
    """EPIC-KITCHENS verb/noun/action multi-view meter: per-video score
    ensembling of the verb and noun heads plus the joint action, the outer
    product of per-clip scores; final top-1/top-5 for verb, noun and
    action."""

    def __init__(self, num_videos, num_clips, num_cls, cfg,
                 ensemble_method="sum"):
        if ensemble_method not in ("sum", "max"):
            raise ValueError(f"ensemble method {ensemble_method!r}")
        self.cfg = cfg
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        self.num_cls = tuple(num_cls)
        self.video_preds = {
            "verb_class": np.zeros((num_videos, num_cls[0]), np.float64),
            "noun_class": np.zeros((num_videos, num_cls[1]), np.float64),
            "action": np.zeros((num_videos, num_cls[0] * num_cls[1]),
                               np.float64),
        }
        self.video_labels = {
            "verb_class": np.zeros((num_videos,), np.int64),
            "noun_class": np.zeros((num_videos,), np.int64),
        }
        self.clip_count = np.zeros((num_videos,), np.int64)
        # the loader pads the final batch by cycling earlier indices; each
        # view counts exactly once
        self.seen = np.zeros((num_videos * num_clips,), bool)
        self.stats = {}
        self.timing = {}

    def reset(self):
        for v in self.video_preds.values():
            v[:] = 0
        self.clip_count[:] = 0
        self.seen[:] = False

    def update_stats(self, preds, labels, clip_ids):
        """preds: {"verb_class": (N, V), "noun_class": (N, Nn)} softmax
        scores; labels: {"verb_class": (N,), "noun_class": (N,)}."""
        verb = np.asarray(preds["verb_class"])
        noun = np.asarray(preds["noun_class"])
        clip_ids = np.asarray(clip_ids)
        action = (verb[:, :, None] * noun[:, None, :]).reshape(verb.shape[0], -1)
        for i in range(verb.shape[0]):
            if self.seen[int(clip_ids[i])]:
                continue  # padded duplicate view
            self.seen[int(clip_ids[i])] = True
            vid = int(clip_ids[i]) // self.num_clips
            if self.clip_count[vid] == 0:
                self.video_labels["verb_class"][vid] = labels["verb_class"][i]
                self.video_labels["noun_class"][vid] = labels["noun_class"][i]
            for key, scores in (("verb_class", verb[i]), ("noun_class", noun[i]),
                                ("action", action[i])):
                if self.ensemble_method == "sum":
                    self.video_preds[key][vid] += scores
                else:
                    self.video_preds[key][vid] = np.maximum(
                        self.video_preds[key][vid], scores)
            self.clip_count[vid] += 1

    def finalize_metrics(self, ks=(1, 5)):
        stats = {"_type": "test_final_epic"}
        action_labels = (self.video_labels["verb_class"] * self.num_cls[1]
                         + self.video_labels["noun_class"])
        for name, preds, labels in (
                ("verb", self.video_preds["verb_class"],
                 self.video_labels["verb_class"]),
                ("noun", self.video_preds["noun_class"],
                 self.video_labels["noun_class"]),
                ("action", self.video_preds["action"], action_labels)):
            order = np.argsort(-preds, axis=1)
            for k in ks:
                correct = (order[:, :k] == labels[:, None]).any(axis=1)
                stats[f"{name}_top{k}_acc"] = f"{100.0 * correct.mean():.2f}"
        self.stats = stats
        logging.log_json_stats(stats)
        return stats


class TestMeter:
    """Multi-view ensembling test meter: per-clip scores summed (or
    maxed) per video, each view counted once.

    ``timing`` holds what the test loop measured: its batches, its wall
    time and the part of it spent waiting on the loader (seconds)."""

    def __init__(self, num_videos, num_clips, num_cls, cfg, ensemble_method="sum"):
        if ensemble_method not in ("sum", "max"):
            raise ValueError(f"ensemble method {ensemble_method!r}")
        self.cfg = cfg
        self.num_clips = num_clips
        self.ensemble_method = ensemble_method
        self.video_preds = np.zeros((num_videos, num_cls), np.float64)
        self.video_labels = np.zeros((num_videos,), np.int64)
        self.clip_count = np.zeros((num_videos,), np.int64)
        # padded duplicate views (the loader cycles indices to keep the
        # batch shape) count exactly once
        self.seen = np.zeros((num_videos * num_clips,), bool)
        self.stats = {}
        self.timing = {}

    def reset(self):
        self.video_preds[:] = 0
        self.video_labels[:] = 0
        self.clip_count[:] = 0
        self.seen[:] = False

    def update_stats(self, preds, labels, clip_ids):
        """preds (N, C) scores per clip view; clip_ids = global dataset index
        = vid_id * num_clips + view_id."""
        preds = np.asarray(preds)
        labels = np.asarray(labels)
        clip_ids = np.asarray(clip_ids)
        for i in range(preds.shape[0]):
            if self.seen[int(clip_ids[i])]:
                continue  # padded duplicate view
            self.seen[int(clip_ids[i])] = True
            vid_id = int(clip_ids[i]) // self.num_clips
            if self.clip_count[vid_id] == 0:
                self.video_labels[vid_id] = labels[i]
            elif self.video_labels[vid_id] != labels[i]:
                raise ValueError(f"label mismatch for video {vid_id}")
            if self.ensemble_method == "sum":
                self.video_preds[vid_id] += preds[i]
            else:
                self.video_preds[vid_id] = np.maximum(
                    self.video_preds[vid_id], preds[i])
            self.clip_count[vid_id] += 1

    def finalize_metrics(self, ks=(1, 5)):
        if not np.all(self.clip_count == self.num_clips):
            incomplete = np.argwhere(self.clip_count != self.num_clips).flatten()
            logger.warning(
                "clip count incomplete for videos %s (%s)",
                incomplete[:16], self.clip_count[incomplete][:16])
        order = np.argsort(-self.video_preds, axis=1)
        stats = {"_type": "test_final"}
        for k in ks:
            correct = (order[:, :k] == self.video_labels[:, None]).any(axis=1)
            stats[f"top{k}_acc"] = f"{100.0 * correct.mean():.2f}"
        self.stats = stats
        logging.log_json_stats(stats)
        return stats
