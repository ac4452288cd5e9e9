"""Untrimmed long video for HiCo/HiCo++ pretraining (port of
``dist_tpu/data/long_video.py``).

Annotation format: ``{split}.txt`` lines ``video_name,start_ms,end_ms``,
the sub-clips of each untrimmed video, one file each
(``<root>/<split>/v_<name>_<start>_<end>.mp4``). One sample is one
untrimmed video, from which ``NUM_CLIPS_PER_VIDEO`` clips are placed by
HiCo's strategy:

- VCL: each clip within ``HICO.VCL.MAX_DIS`` seconds of the one before;
- gradual: that distance anneals from ``GRAUDAL_SAMPLING.MAX_DIS[0]`` to
  ``[1]`` over training, the progress given by :meth:`set_epoch_rate`
  (the train loop calls it at each fold-epoch);
- TCL: the last clip placed freely (a distant "topic" sample);
- HiCo++ (``DATA.HICO_PLUS_PLUS.ENABLE``): pairs, a free (or
  ``TCL.MAX_DIS``-near) clip and one near it.

The placements draw on the sample's numpy ``rng`` in the JAX package's
order, so both packages place the same clips; frames come from the
port's native decoder.
"""

import os

import numpy as np

from dist_tpu_torch.data.base_dataset import (
    DATASET_REGISTRY,
    BaseVideoDataset,
    probe_video,
    read_video,
)
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


@DATASET_REGISTRY.register()
class Longvideo(BaseVideoDataset):
    SPLIT_TABLE = {"train": "training", "test": "testing", "val": "validation"}

    def __init__(self, cfg, split):
        self.epoch_rate = 0.0
        super().__init__(cfg, split)

    def set_epoch_rate(self, rate):
        """The curriculum's progress in [0, 1]."""
        self.epoch_rate = float(rate)

    def _get_dataset_list_name(self):
        return f"{self.SPLIT_TABLE[self.split]}.txt"

    def _construct_dataset(self, cfg):
        path = os.path.join(self.anno_dir, self._get_dataset_list_name())
        self._samples = []
        self._spatial_temporal_index = []
        self._video_clips = {}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                video_name, start_ms, end_ms = line.split(",")
                if video_name not in self._video_clips:
                    self._video_clips[video_name] = []
                    self._samples.append(video_name)
                    self._spatial_temporal_index.append(0)
                self._video_clips[video_name].append(
                    (int(start_ms) / 1000.0, int(end_ms) / 1000.0))
        if not self._samples:
            raise ValueError(f"Loading at {path} failed: no samples.")
        logger.info("Longvideo split %s: %d videos.", self.split,
                    len(self._samples))

    def _get_sample_info(self, index):
        video_name = self._samples[index]
        clips = self._video_clips[video_name]
        return {"path": video_name, "supervised_label": 0,
                "duration": clips[-1][1], "clips": clips}

    # ---- HiCo clip placement ----

    def _clip_centers(self, duration, rng):
        """(clip centres in seconds, a clip's length in seconds)."""
        cfg = self.cfg
        clip_time = (self._num_frames * self._sampling_rate
                     / cfg.DATA.TARGET_FPS)
        n = int(cfg.PRETRAIN.get("NUM_CLIPS_PER_VIDEO", 2))
        hico = cfg.get("HICO")

        def rc(lo, hi):
            hi = max(hi, lo)
            return lo + (hi - lo) * rng.uniform()

        max_dis = -1.0
        tcl_free_last = False
        if hico is not None:
            if hico.get("GRAUDAL_SAMPLING") and hico.GRAUDAL_SAMPLING.ENABLE:
                lo, hi = hico.GRAUDAL_SAMPLING.MAX_DIS
                max_dis = lo + (hi - lo) * min(max(self.epoch_rate, 0.0), 1.0)
            elif hico.get("VCL") and hico.VCL.ENABLE:
                max_dis = float(hico.VCL.MAX_DIS)
            tcl_free_last = bool(hico.get("TCL") and hico.TCL.ENABLE)

        lo, hi = clip_time, duration - clip_time
        if cfg.DATA.HICO_PLUS_PLUS.ENABLE:
            if n % 2:
                raise ValueError(f"HiCo++ places clip pairs: "
                                 f"NUM_CLIPS_PER_VIDEO {n} is odd")
            tcl_max_dis = (float(hico.TCL.get("MAX_DIS", -1.0)) if hico
                           else -1.0)
            centers = []
            for _ in range(n // 2):
                if max_dis < 0:
                    centers.append(rc(lo, hi))
                    centers.append(rc(lo, hi))
                else:
                    if tcl_max_dis >= 0 and centers:
                        centers.append(rc(max(centers[-1] - tcl_max_dis, lo),
                                          min(centers[-1] + tcl_max_dis, hi)))
                    else:
                        centers.append(rc(lo, hi))
                    centers.append(rc(max(centers[-1] - max_dis, lo),
                                      min(centers[-1] + max_dis, hi)))
            return centers, clip_time
        centers = [rc(lo, hi)]
        for _ in range(n - 1):
            if max_dis < 0:
                centers.append(rc(lo, hi))
            else:
                centers.append(rc(max(centers[-1] - max_dis, lo),
                                  min(centers[-1] + max_dis, hi)))
        if tcl_free_last:
            centers[-1] = rc(lo, hi)
        return centers, clip_time

    def _clip_frames(self, sample_info, centers, clip_time):
        """[(path, frame indices)] of each placed clip: the sub-clip file
        that holds the clip's start, and ``NUM_INPUT_FRAMES`` indices
        spread evenly over the clip inside it."""
        clips = sample_info["clips"]
        out = []
        for c in centers:
            t0 = max(c - clip_time / 2, 0.0)
            ci = next((i for i, (s, e) in enumerate(clips) if s <= t0 < e), 0)
            path = self._clip_path(sample_info["path"], clips[ci])
            num_frames, fps = probe_video(path)
            start = int(np.clip((t0 - clips[ci][0]) * fps, 0,
                                max(num_frames - 1, 0)))
            span = int(clip_time * fps)
            idx = np.linspace(start, min(start + span, num_frames - 1),
                              self._num_frames).astype(np.int64)
            out.append((path, idx))
        return out

    def _decode_video(self, sample_info, index, rng):
        """One frame stack a placed clip: a list, one view each."""
        centers, clip_time = self._clip_centers(sample_info["duration"], rng)
        return [read_video(path, idx) for path, idx in
                self._clip_frames(sample_info, centers, clip_time)], 0

    def _clip_path(self, video_name, clip):
        s, e = int(clip[0] * 1000), int(clip[1] * 1000)
        sub = self.SPLIT_TABLE[self.split]
        return os.path.join(self.data_root_dir, sub,
                            f"v_{video_name}_{s}_{e}.mp4")
