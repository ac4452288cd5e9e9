"""Spatial transforms (port of ``dist_tpu/data/transforms.py``).

Host side (numpy, uint8 ``(T, H, W, C)`` clips): short-side resize,
random and controlled crops, torchvision-style random-resized crop,
horizontal flip and colour jitter. Decode, resize and crop stay on the
host in uint8, so a clip crosses to the card at one byte per value.

The JAX package resizes with OpenCV (``cv2.INTER_LINEAR``); the card's
machine has no OpenCV, so :func:`_resize` computes OpenCV's uint8 bilinear
arithmetic itself, in integers, on all frames of a clip at once: 11-bit
fixed-point weights and OpenCV's vectorised rounding, equal to
``cv2.resize`` bit for bit.

Device side: :func:`normalize_device`, the float conversion and mean/std
normalisation, runs on the video's device inside the step.
"""

import numpy as np
import torch

_BLUR_TODO = ("gaussian_blur_clip (SSL pretraining views) is not ported yet "
              "(ROADMAP.md queue A: SSL/HiCo pretraining)")


# --------------------------------------------------------------------------
# host side (numpy, uint8 THWC)


# OpenCV's fixed point for uint8 bilinear resizes (INTER_RESIZE_COEF_BITS)
_COEF_SCALE = 2048


def _linear_taps(src, dst, clamp):
    """OpenCV's source indices and 11-bit weights of one axis: -> (i0, i1,
    w0, w1), so that output position d reads i0[d] and i1[d] with weights
    w0[d] + w1[d] ~ 2048. The position is computed in float64 and cast to
    float32, as OpenCV does. ``clamp`` (the columns) pins a position left
    of the first or right of the last source pixel to that pixel with
    weight 0 on its neighbour; the rows keep their fraction at the borders
    and only their two indices are clipped."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    if clamp:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0
        s[low], s[high] = 0, src - 1
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE)).astype(np.int32)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1


def _resize(frames, nh, nw):
    """Bilinear resize of every frame of a uint8 (T, H, W, C) clip to
    (nh, nw), equal to ``cv2.resize(frame, (nw, nh), INTER_LINEAR)`` bit
    for bit: the horizontal pass sums two taps with 11-bit weights exactly
    in int32; the vertical pass rounds as OpenCV's vector code does,
    ``(((b0 (S0 >> 4)) >> 16) + ((b1 (S1 >> 4)) >> 16) + 2) >> 2``. (An
    exact 2x downscale, which OpenCV hands to INTER_AREA, gives the same
    values: each output is its four pixels' rounded mean either way.)"""
    t, h, w, c = frames.shape
    y0, y1, b0, b1 = _linear_taps(h, nh, clamp=False)
    x0, x1, a0, a1 = _linear_taps(w, nw, clamp=True)
    # the horizontal pass on each source row the output reads, once
    rows, which = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    x = frames[:, rows].reshape(t, len(rows), w * c)
    channels = np.arange(c)
    s = np.take(x, (x0[:, None] * c + channels).ravel(), axis=2)
    s = s.astype(np.int32) * np.repeat(a0, c)
    s1 = np.take(x, (x1[:, None] * c + channels).ravel(), axis=2)
    s += s1.astype(np.int32) * np.repeat(a1, c)
    s >>= 4
    out = np.take(s, which[:nh], axis=1)
    out *= b0[:, None]
    out >>= 16
    lower = np.take(s, which[nh:], axis=1)
    lower *= b1[:, None]
    lower >>= 16
    out += lower
    out += 2
    out >>= 2
    np.minimum(out, 255, out=out)
    return out.astype(np.uint8).reshape(t, nh, nw, c)


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
