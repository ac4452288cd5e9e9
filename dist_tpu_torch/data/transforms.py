"""Spatial transforms (port of ``dist_tpu/data/transforms.py``).

Host side (numpy, uint8 ``(T, H, W, C)`` clips): short-side resize,
random and controlled crops, torchvision-style random-resized crop,
horizontal flip and colour jitter. Decode, resize and crop stay on the
host in uint8, so a clip crosses to the card at one byte per value.

The JAX package resizes with OpenCV (``cv2.INTER_LINEAR``); the card's
machine has no OpenCV, so the port resizes with ``F.interpolate``
(bilinear, half-pixel centres, no antialias) on all frames of a clip at
once, in float32, rounded to uint8. OpenCV rounds its bilinear weights to
11 bits, so the two differ by at most 1 in some values.

Device side: :func:`normalize_device`, the float conversion and mean/std
normalisation, runs on the video's device inside the step.
"""

import numpy as np
import torch
import torch.nn.functional as F

_BLUR_TODO = ("gaussian_blur_clip (SSL pretraining views) is not ported yet "
              "(ROADMAP.md queue A, item 5: SSL/HiCo)")


# --------------------------------------------------------------------------
# host side (numpy, uint8 THWC)


def _resize(frames, nh, nw):
    """Bilinear resize of every frame of a uint8 (T, H, W, C) clip to
    (nh, nw), as one batched interpolation in float32, rounded."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)
    y = F.interpolate(x.float(), size=(nh, nw), mode="bilinear",
                      align_corners=False, antialias=False)
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y.permute(0, 2, 3, 1).contiguous().numpy()


def resize_short_side(frames, length):
    """Bilinear resize so the short side == length. frames (T,H,W,C) uint8."""
    t, h, w, c = frames.shape
    if h < w:
        nh, nw = int(length), int(w / h * int(length))
    else:
        nw, nh = int(length), int(h / w * int(length))
    if (nh, nw) == (h, w):
        return frames
    return _resize(frames, nh, nw)


def kinetics_resized_crop_random(frames, short_side_range, crop_size, rng):
    """Train path of KineticsResizedCrop (transformations.py:469-488)."""
    side = int(rng.uniform(short_side_range[0], short_side_range[1]))
    frames = resize_short_side(frames, side)
    _, h, w, _ = frames.shape
    y = int(rng.uniform(0, max(h - crop_size, 0) + 1e-9))
    x = int(rng.uniform(0, max(w - crop_size, 0) + 1e-9))
    return frames[:, y:y + crop_size, x:x + crop_size]


def kinetics_resized_crop_controlled(frames, test_scale, crop_size,
                                     num_spatial_crops, spatial_idx):
    """Test path (transformations.py:427-467): resize short side to
    test_scale; 1 crop = center, 3 crops = start/center/end along the long
    side."""
    frames = resize_short_side(frames, test_scale)
    _, h, w, _ = frames.shape
    x_max, y_max = w - crop_size, h - crop_size
    if num_spatial_crops == 1:
        x, y = x_max // 2, y_max // 2
    elif num_spatial_crops == 3:
        short_is_w = w == test_scale
        if spatial_idx == 0:
            x, y = (x_max // 2, 0) if short_is_w else (0, y_max // 2)
        elif spatial_idx == 1:
            x, y = x_max // 2, y_max // 2
        else:
            x, y = (x_max // 2, y_max) if short_is_w else (x_max, y_max // 2)
    else:
        raise NotImplementedError(num_spatial_crops)
    return frames[:, y:y + crop_size, x:x + crop_size]


def random_resized_crop(frames, crop_size, scale, ratio, rng):
    """torchvision RandomResizedCrop semantics over a clip: one crop window
    shared by all frames."""
    t, h, w, c = frames.shape
    area = h * w
    for _ in range(10):
        target_area = rng.uniform(scale[0], scale[1]) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            y = int(rng.integers(0, h - ch + 1))
            x = int(rng.integers(0, w - cw + 1))
            crop = frames[:, y:y + ch, x:x + cw]
            break
    else:
        # center fallback
        side = min(h, w)
        y, x = (h - side) // 2, (w - side) // 2
        crop = frames[:, y:y + side, x:x + side]
    if crop.shape[1:3] == (crop_size, crop_size):
        return np.ascontiguousarray(crop)
    return _resize(crop, crop_size, crop_size)


def auto_resized_crop(frames, scale_range, crop_size, mode, rng=None):
    """7-position controlled crop after short-side resize
    (reference AutoResizedCropVideo, transformations.py:322-413):
    cc center, ll/rr left/right, tl/tr/bl/br corners, or "rand"."""
    positions = ("cc", "ll", "rr", "tl", "tr", "bl", "br")
    if mode == "rand":
        rng = rng or np.random.default_rng()
        mode = positions[int(rng.integers(len(positions)))]
    if mode not in positions:
        raise ValueError(f"crop position {mode!r} not in {positions}")
    if rng is not None and scale_range[0] < scale_range[1]:
        scale = rng.uniform(scale_range[0], scale_range[1])
    else:
        scale = scale_range[0]
    side = int(round(crop_size / scale)) if scale <= 1 else int(round(scale))
    frames = resize_short_side(frames, max(side, crop_size))
    _, h, w, _ = frames.shape
    x_max, y_max = w - crop_size, h - crop_size
    x = {"cc": x_max // 2, "ll": 0, "rr": x_max, "tl": 0, "tr": x_max,
         "bl": 0, "br": x_max}[mode]
    y = {"cc": y_max // 2, "ll": y_max // 2, "rr": y_max // 2, "tl": 0,
         "tr": 0, "bl": y_max, "br": y_max}[mode]
    return frames[:, y:y + crop_size, x:x + crop_size]


def horizontal_flip(frames):
    return frames[:, :, ::-1]


_RGB2GRAY = np.asarray([0.299, 0.587, 0.114], np.float32)


def _rgb2hsv(x):
    """Vectorized RGB->HSV on float (..., 3) in [0,1]
    (reference _rgb2hsv, transformations.py:206-225)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    maxc = x.max(axis=-1)
    minc = x.min(axis=-1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = np.ones_like(maxc)
    s = cr / np.where(eqc, ones, maxc)
    cr_div = np.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    h = ((maxc == r) * (bc - gc)
         + ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
         + ((maxc != g) & (maxc != r)) * (4.0 + gc - rc))
    h = np.mod(h / 6.0 + 1.0, 1.0)
    return h, s, maxc


def _hsv2rgb(h, s, v):
    """Vectorized HSV->RGB (reference _hsv2rgb, transformations.py:227-257)."""
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int32) % 6
    p = np.clip(v * (1.0 - s), 0.0, 1.0)
    q = np.clip(v * (1.0 - s * f), 0.0, 1.0)
    t = np.clip(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    # channel value by sextant
    idx = i[..., None]
    r = np.take_along_axis(np.stack([v, q, p, p, t, v], axis=-1), idx, axis=-1)
    g = np.take_along_axis(np.stack([t, v, v, q, p, p], axis=-1), idx, axis=-1)
    b = np.take_along_axis(np.stack([p, p, t, v, v, q], axis=-1), idx, axis=-1)
    return np.concatenate([r, g, b], axis=-1)


def color_jitter_clip(frames, rng, brightness=0, contrast=0, saturation=0,
                      hue=0, grayscale=0, consistent=True, shuffle=True,
                      gray_first=True, p=1.0):
    """Color jitter on uint8 (T,H,W,C) frames with the reference ColorJitter
    semantics (transformations.py:36-320):

    - per-op factors drawn once per clip (``consistent=True``) or per frame,
    - brightness = blend toward zero; contrast = blend toward the per-frame
      grayscale mean; saturation = blend toward per-pixel grayscale;
      hue = cyclic shift in HSV space,
    - op order shuffled when ``shuffle`` (``AUGMENTATION.SHUFFLE``),
    - grayscale applied with prob ``grayscale``, first or last in the chain
      per ``gray_first`` (``AUGMENTATION.GRAY_FIRST``); it is applied even
      when the jitter prob ``p`` gate fails, like the reference.
    """
    t = frames.shape[0]
    perform = rng.uniform() < p

    def factor(lo, hi, shape=(t, 1, 1, 1)):
        if consistent:
            return np.float32(rng.uniform(lo, hi))
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    ops = []
    if brightness > 0 and perform:
        f_b = factor(max(0, 1 - brightness), 1 + brightness)
        ops.append(lambda x: np.clip(x * f_b, 0.0, 1.0))
    if contrast > 0 and perform:
        f_c = factor(max(0, 1 - contrast), 1 + contrast)

        def _contrast(x):
            mean = (x @ _RGB2GRAY).mean(axis=(1, 2))[:, None, None, None]
            return np.clip((x - mean) * f_c + mean, 0.0, 1.0)
        ops.append(_contrast)
    if saturation > 0 and perform:
        f_s = factor(max(0, 1 - saturation), 1 + saturation)

        def _saturation(x):
            gray = (x @ _RGB2GRAY)[..., None]
            return np.clip((x - gray) * f_s + gray, 0.0, 1.0)
        ops.append(_saturation)
    if hue > 0 and perform:
        f_h = factor(-hue, hue, shape=(t, 1, 1))

        def _hue(x):
            hh, ss, vv = _rgb2hsv(x)
            hh = np.mod(hh + f_h, 1.0)
            return _hsv2rgb(hh, ss, vv)
        ops.append(_hue)

    if shuffle and perform:
        rng.shuffle(ops)
    if grayscale > 0 and rng.uniform() < grayscale:
        def _gray(x):
            g = (x @ _RGB2GRAY)[..., None]
            return np.repeat(g, 3, axis=-1)
        ops.insert(0, _gray) if gray_first else ops.append(_gray)

    if not ops:
        return frames
    x = frames.astype(np.float32) / 255.0
    for op in ops:
        x = op(x)
    return (np.clip(x, 0, 1) * 255).astype(np.uint8)


def gaussian_blur_clip(frames, rng, sigma_range=(0.1, 2.0)):
    """SimCLR-style Gaussian blur of SSL pretraining views: not ported."""
    raise NotImplementedError(_BLUR_TODO)


# --------------------------------------------------------------------------
# device side


def normalize_device(video_u8, mean, std):
    """uint8 (B, T, H, W, C) -> normalised float32 on the video's device."""
    mean = torch.tensor(mean, dtype=torch.float32, device=video_u8.device) * 255.0
    std = torch.tensor(std, dtype=torch.float32, device=video_u8.device) * 255.0
    return (video_u8.float() - mean) / std
