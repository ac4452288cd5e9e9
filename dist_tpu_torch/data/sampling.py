"""Temporal frame-index sampling (port of ``dist_tpu/data/sampling.py``,
a copy: pure numpy, the RNG passed explicitly)."""

import numpy as np


def interval_based_sampling(vid_length, vid_fps, clip_idx, num_clips,
                            num_frames, interval, target_fps=30,
                            minus_interval=False, rng=None):
    """fps-normalized window sampling (base_dataset.py:513-549).

    clip_idx == -1: random window start (train); otherwise the clip_idx-th
    of num_clips evenly placed windows (test views).
    """
    if num_frames == 1:
        rng = rng or np.random.default_rng()
        return np.asarray([rng.integers(0, vid_length)], np.int64)
    clip_length = num_frames * interval * vid_fps / target_fps
    max_idx = max(vid_length - clip_length, 0)
    if clip_idx == -1:
        rng = rng or np.random.default_rng()
        start_idx = rng.uniform(0, max_idx)
    elif num_clips == 1:
        start_idx = max_idx / 2
    else:
        start_idx = max_idx * clip_idx / num_clips
    if minus_interval:
        end_idx = start_idx + clip_length - interval
    else:
        end_idx = start_idx + clip_length - 1
    index = np.linspace(start_idx, end_idx, num_frames)
    return np.clip(index, 0, vid_length - 1).astype(np.int64)


def segment_based_sampling(vid_length, clip_idx, num_clips, num_frames,
                           random_sample, rng=None):
    """TSN-style per-segment sampling (base_dataset.py:551-576)."""
    index = np.zeros(num_frames)
    index_range = np.linspace(0, vid_length, num_frames + 1)
    if random_sample:
        rng = rng or np.random.default_rng()
        for i in range(num_frames):
            index[i] = rng.uniform(index_range[i], index_range[i + 1])
    else:
        for i in range(num_frames):
            if num_clips == 1:
                index[i] = (index_range[i] + index_range[i + 1]) / 2
            else:
                index[i] = index_range[i] + (
                    index_range[i + 1] - index_range[i]) * (clip_idx + 1) / num_clips
    return np.round(np.clip(index, 0, vid_length - 1)).astype(np.int64)


def get_frame_indices(cfg, vid_length, vid_fps, clip_idx, num_clips, rng=None,
                      random_sample=False):
    """Dispatch on DATA.SAMPLING_MODE (base_dataset.py:164-185)."""
    num_frames = cfg.DATA.NUM_INPUT_FRAMES
    mode = cfg.DATA.SAMPLING_MODE
    if mode == "interval_based":
        return interval_based_sampling(
            vid_length, vid_fps, clip_idx, num_clips, num_frames,
            cfg.DATA.SAMPLING_RATE, target_fps=cfg.DATA.TARGET_FPS,
            minus_interval=bool(cfg.DATA.get("MINUS_INTERVAL", False)), rng=rng)
    elif mode == "segment_based":
        return segment_based_sampling(
            vid_length, clip_idx, num_clips, num_frames, random_sample, rng=rng)
    raise NotImplementedError(f"Sampling mode {mode} not supported")
