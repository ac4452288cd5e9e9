"""Device-side video normalisation (port of ``normalize_device`` of
``dist_tpu/data/transforms.py``); the host-side transforms come with the
eval run-list slice."""

import torch


def normalize_device(video_u8, mean, std):
    """uint8 (B, T, H, W, C) -> normalised float32 on the video's device."""
    mean = torch.tensor(mean, dtype=torch.float32, device=video_u8.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=video_u8.device) * 255.0
    return (video_u8.float() - mean) / std
