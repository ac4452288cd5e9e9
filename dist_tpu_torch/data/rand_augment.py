"""RandAugment, AutoAugment, AugMix and random erasing for uint8
``(T, H, W, C)`` clips (port of ``dist_tpu/data/rand_augment.py``).

Every frame of a clip gets the same ops at the same magnitudes. The ops,
the level mappers, the policy tables and the order in which each draws
from the sample's numpy ``Generator`` are the JAX package's, so that one
seeded ``Generator`` gives the same uint8 clip in both packages.

The JAX package calls OpenCV for four of the ops; the card's machine has
no OpenCV, so each call has a numpy twin here, equal to OpenCV's uint8
result bit for bit:

- ``cv2.equalizeHist`` (Equalize): :func:`_equalize_hist`, OpenCV's LUT
  from a float32 scale and round-half-to-even;
- ``cv2.getRotationMatrix2D`` and ``cv2.warpAffine`` with
  ``INTER_LINEAR`` and a constant 0 border (Rotate, ShearX/Y,
  TranslateX/Y): :func:`_rotation_matrix` and :func:`_warp_affine`,
  OpenCV's float32 bilinear kernels (see there);
- ``cv2.GaussianBlur(x, (3, 3), 0)`` (Sharpness): the port's integer
  blur, ``transforms._blur_frames``, with OpenCV's fixed 3-tap table.
"""

import math

import numpy as np

from dist_tpu_torch.data.transforms import _blur_frames

_MAX_LEVEL = 10.0


# --------------------------------------------------------------------------
# OpenCV twins


def _equalize_hist(x):
    """``cv2.equalizeHist`` of every (frame, channel) plane of a uint8
    (T, H, W, C) clip. Per plane, with ``i`` its smallest value and ``n``
    its pixel count: ``scale = 255.f / (n - hist[i])`` in float32, and
    value ``j > i`` maps to ``round_half_even(float(sum(hist[i+1..j])) *
    scale)``; ``i`` maps to 0 and a one-value plane stays as it is."""
    t, h, w, c = x.shape
    planes = np.moveaxis(x, -1, 1).reshape(t * c, h * w)
    offsets = (np.arange(t * c) * 256)[:, None]
    hist = np.bincount((planes + offsets).ravel(),
                       minlength=t * c * 256).reshape(t * c, 256)
    first = np.argmax(hist > 0, axis=1)
    rows = np.arange(t * c)
    rest = (h * w - hist[rows, first]).astype(np.float32)
    single = rest == 0
    scale = np.float32(255.0) / np.where(single, np.float32(1), rest)
    # sum(hist[i+1..j]) for j > i: the cumulative count less that up to i
    csum = np.cumsum(hist, axis=1)
    partial = (csum - csum[rows, first][:, None]).astype(np.float32)
    lut = np.rint(partial * scale[:, None])
    lut = np.clip(lut, 0, 255).astype(np.uint8)
    lut[single] = np.arange(256, dtype=np.uint8)
    out = np.take_along_axis(lut, planes.astype(np.intp), axis=1)
    return np.moveaxis(out.reshape(t, c, h, w), 1, -1)


def _rotation_matrix(cx, cy, deg):
    """``cv2.getRotationMatrix2D((cx, cy), deg, 1.0)``: the centre as
    float32, the rest in double."""
    cx, cy = float(np.float32(cx)), float(np.float32(cy))
    angle = deg * (math.pi / 180)
    alpha, beta = math.cos(angle), math.sin(angle)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m):
    """OpenCV's inverse of a 2 x 3 affine map, in double."""
    m = [float(v) for v in np.asarray(m, np.float64).ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


# columns OpenCV's x86 vector loop of warpAffine steps at a time; the
# columns past the last whole step are computed by its scalar code, which
# rounds the source coordinate differently
WARP_LANES = 16


def _warp_affine(frames, m):
    """``cv2.warpAffine(frame, m, (W, H))`` (``INTER_LINEAR``,
    ``BORDER_CONSTANT`` 0) of every frame of a uint8 (T, H, W, C) clip,
    as OpenCV computes it in float32: the inverse map in double, cast to
    float32; each output pixel's source ``(sx, sy)`` as
    ``fma(x, M0, y * M1 + M2)`` in the vector loop and ``fma(x, M0, y *
    M1) + M2`` in the scalar tail; taps at ``floor(sx), floor(sy)`` and
    the next, reading 0 outside the frame; ``p0 = fma(a, p01 - p00,
    p00)``, ``p1`` likewise, ``p = fma(b, p1 - p0, p0)`` with ``a = sx -
    floor(sx)``; rounded half to even and saturated."""
    t, h, w, c = frames.shape
    mf = np.asarray(_invert_affine(m), np.float32)
    xs = np.arange(w, dtype=np.float32)[None, :]
    ys = np.arange(h, dtype=np.float32)[:, None]
    sx = _fma(xs, mf[0], ys * mf[1] + mf[2])
    sy = _fma(xs, mf[3], ys * mf[4] + mf[5])
    tail = (w // WARP_LANES) * WARP_LANES
    if tail < w:
        sx[:, tail:] = _fma(xs[:, tail:], mf[0], ys * mf[1]) + mf[2]
        sy[:, tail:] = _fma(xs[:, tail:], mf[3], ys * mf[4]) + mf[5]
    fx, fy = np.floor(sx), np.floor(sy)
    a = (sx - fx)[..., None]
    b = (sy - fy)[..., None]
    # two rings of zeros: a tap anywhere outside the frame reads one, and
    # the flat index of tap (y, x) in the padded frame is y * (w + 4) + x
    wp = w + 4
    ix = np.clip(fx, -2, w).astype(np.intp) + 2
    iy = np.clip(fy, -2, h).astype(np.intp) + 2
    i00 = (iy * wp + ix).ravel()
    pad = np.zeros((t, h + 4, wp, c), np.float32)
    pad[:, 2:-2, 2:-2] = frames
    pad = pad.reshape(t, (h + 4) * wp, c)

    def tap(offset):
        return np.take(pad, i00 + offset, axis=1).reshape(t, h, w, c)

    p00, p01, p10, p11 = tap(0), tap(1), tap(wp), tap(wp + 1)
    p0 = _fma(a, p01 - p00, p00)
    p1 = _fma(a, p11 - p10, p10)
    p = _fma(b, p1 - p0, p0)
    return np.clip(np.rint(p), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# primitive image ops on uint8 clips (T, H, W, C)


def _blend(a, b, alpha):
    return np.clip(a.astype(np.float32) * alpha
                   + b.astype(np.float32) * (1 - alpha), 0, 255).astype(np.uint8)


def _autocontrast(x, _arg):
    lo = x.min(axis=(0, 1, 2), keepdims=True).astype(np.float32)
    hi = x.max(axis=(0, 1, 2), keepdims=True).astype(np.float32)
    scale = 255.0 / np.maximum(hi - lo, 1)
    return np.clip((x - lo) * scale, 0, 255).astype(np.uint8)


def _equalize(x, _arg):
    return _equalize_hist(x)


def _invert(x, _arg):
    return 255 - x


def _rotate(x, deg):
    t, h, w, c = x.shape
    return _warp_affine(x, _rotation_matrix(w / 2, h / 2, deg))


def _posterize(x, bits):
    bits = int(np.clip(bits, 1, 8))  # 0 bits would be a black image
    mask = 256 - (1 << (8 - bits))
    return (x & mask).astype(np.uint8)


def _solarize(x, thr):
    return np.where(x >= thr, 255 - x, x).astype(np.uint8)


def _solarize_add(x, add, thr=128):
    lut = np.arange(256, dtype=np.int32)
    lut = np.where(lut < thr, np.clip(lut + int(add), 0, 255), lut)
    return lut.astype(np.uint8)[x]


def _color(x, factor):
    gray = (x @ np.asarray([0.299, 0.587, 0.114], np.float32))[..., None]
    return _blend(x, np.repeat(gray, 3, axis=-1), factor)


def _contrast(x, factor):
    mean = float(x.astype(np.float32).mean())
    return _blend(x, np.full_like(x, int(mean)), factor)


def _brightness(x, factor):
    return _blend(x, np.zeros_like(x), factor)


def _sharpness(x, factor):
    return _blend(x, _blur_frames(x, 3, 0), factor)


def _shear_x(x, s):
    return _warp_affine(x, np.float32([[1, s, 0], [0, 1, 0]]))


def _shear_y(x, s):
    return _warp_affine(x, np.float32([[1, 0, 0], [s, 1, 0]]))


def _translate_x(x, px):
    return _warp_affine(x, np.float32([[1, 0, px], [0, 1, 0]]))


def _translate_y(x, px):
    return _warp_affine(x, np.float32([[1, 0, 0], [0, 1, px]]))


def _translate_x_rel(x, frac):
    return _translate_x(x, frac * x.shape[2])


def _translate_y_rel(x, frac):
    return _translate_y(x, frac * x.shape[1])


# --------------------------------------------------------------------------
# level -> op-argument mappers; ``rng`` draws the random sign of the
# symmetric ops


def _signed(v, rng):
    return -v if rng.uniform() > 0.5 else v


def _rotate_level(level, rng):
    return _signed((level / _MAX_LEVEL) * 30.0, rng)


def _shear_level(level, rng):
    return _signed((level / _MAX_LEVEL) * 0.3, rng)


def _translate_rel_level(level, rng):
    return _signed((level / _MAX_LEVEL) * 0.45, rng)


def _enhance_level(level, rng):
    # non-increasing: a factor in [0.1, 1.9] from the level
    return (level / _MAX_LEVEL) * 1.8 + 0.1


def _enhance_increasing_level(level, rng):
    # "inc": the severity grows with the level, in a random direction
    return 1.0 + _signed((level / _MAX_LEVEL) * 0.9, rng)


def _posterize_level(level, rng):
    return int((level / _MAX_LEVEL) * 4)


def _posterize_increasing_level(level, rng):
    return 4 - int((level / _MAX_LEVEL) * 4)


def _posterize_original_level(level, rng):
    return int((level / _MAX_LEVEL) * 4) + 4


def _solarize_level(level, rng):
    return min(256, int((level / _MAX_LEVEL) * 256))


def _solarize_increasing_level(level, rng):
    return 256 - _solarize_level(level, rng)


def _solarize_add_level(level, rng):
    return min(128, int((level / _MAX_LEVEL) * 110))


_OPS = {
    # name: (op, level mapper or None)
    "AutoContrast": (_autocontrast, None),
    "Equalize": (_equalize, None),
    "Invert": (_invert, None),
    "Rotate": (_rotate, _rotate_level),
    "Posterize": (_posterize, _posterize_level),
    "PosterizeIncreasing": (_posterize, _posterize_increasing_level),
    "PosterizeOriginal": (_posterize, _posterize_original_level),
    "Solarize": (_solarize, _solarize_level),
    "SolarizeIncreasing": (_solarize, _solarize_increasing_level),
    "SolarizeAdd": (_solarize_add, _solarize_add_level),
    "Color": (_color, _enhance_level),
    "ColorIncreasing": (_color, _enhance_increasing_level),
    "Contrast": (_contrast, _enhance_level),
    "ContrastIncreasing": (_contrast, _enhance_increasing_level),
    "Brightness": (_brightness, _enhance_level),
    "BrightnessIncreasing": (_brightness, _enhance_increasing_level),
    "Sharpness": (_sharpness, _enhance_level),
    "SharpnessIncreasing": (_sharpness, _enhance_increasing_level),
    "ShearX": (_shear_x, _shear_level),
    "ShearY": (_shear_y, _shear_level),
    "TranslateX": (_translate_x_rel, _translate_rel_level),
    "TranslateY": (_translate_y_rel, _translate_rel_level),
    "TranslateXRel": (_translate_x_rel, _translate_rel_level),
    "TranslateYRel": (_translate_y_rel, _translate_rel_level),
}


def apply_op(name, frames, level, rng):
    fn, level_fn = _OPS[name]
    arg = level_fn(level, rng) if level_fn is not None else None
    return fn(frames, arg)


# the RandAugment op pools: the "inc" (increasing-severity) set the
# recipes use, and the default set
_RAND_INCREASING = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "PosterizeIncreasing",
    "SolarizeIncreasing", "SolarizeAdd", "ColorIncreasing",
    "ContrastIncreasing", "BrightnessIncreasing", "SharpnessIncreasing",
    "ShearX", "ShearY", "TranslateXRel", "TranslateYRel",
]
_RAND_DEFAULT = [
    "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize", "Solarize",
    "SolarizeAdd", "Color", "Contrast", "Brightness", "Sharpness", "ShearX",
    "ShearY", "TranslateXRel", "TranslateYRel",
]

_AUGMIX_TRANSFORMS = [
    "AutoContrast", "ColorIncreasing", "ContrastIncreasing",
    "BrightnessIncreasing", "SharpnessIncreasing", "Equalize", "Rotate",
    "PosterizeIncreasing", "SolarizeIncreasing", "ShearX", "ShearY",
    "TranslateXRel", "TranslateYRel",
]


def _jitter(magnitude, mag_std, rng):
    if mag_std == float("inf"):
        return float(rng.uniform(0, magnitude))
    if mag_std > 0:
        return float(np.clip(rng.normal(magnitude, mag_std), 0, _MAX_LEVEL))
    return float(magnitude)


class RandAugment:
    """``rand-mN-nK-mstdS``: K random ops at a magnitude ~N(mag, std),
    each firing with probability 0.5."""

    def __init__(self, magnitude=9, num_ops=2, mag_std=0.5, increasing=True):
        self.magnitude = magnitude
        self.num_ops = num_ops
        self.mag_std = mag_std
        self.ops = list(_RAND_INCREASING if increasing else _RAND_DEFAULT)

    def __call__(self, frames, rng=None):
        rng = rng or np.random.default_rng()
        for _ in range(self.num_ops):
            if rng.uniform() > 0.5:
                continue
            name = self.ops[int(rng.integers(len(self.ops)))]
            frames = apply_op(name, frames,
                              _jitter(self.magnitude, self.mag_std, rng), rng)
        return frames


# AutoAugment sub-policy tables: (op name, probability, magnitude)
_POLICY_V0 = [
    [("Equalize", 0.8, 1), ("ShearY", 0.8, 4)],
    [("Color", 0.4, 9), ("Equalize", 0.6, 3)],
    [("Color", 0.4, 1), ("Rotate", 0.6, 8)],
    [("Solarize", 0.8, 3), ("Equalize", 0.4, 7)],
    [("Solarize", 0.4, 2), ("Solarize", 0.6, 2)],
    [("Color", 0.2, 0), ("Equalize", 0.8, 8)],
    [("Equalize", 0.4, 8), ("SolarizeAdd", 0.8, 3)],
    [("ShearX", 0.2, 9), ("Rotate", 0.6, 8)],
    [("Color", 0.6, 1), ("Equalize", 1.0, 2)],
    [("Invert", 0.4, 9), ("Rotate", 0.6, 0)],
    [("Equalize", 1.0, 9), ("ShearY", 0.6, 3)],
    [("Color", 0.4, 7), ("Equalize", 0.6, 0)],
    [("Posterize", 0.4, 6), ("AutoContrast", 0.4, 7)],
    [("Solarize", 0.6, 8), ("Color", 0.6, 9)],
    [("Solarize", 0.2, 4), ("Rotate", 0.8, 9)],
    [("Rotate", 1.0, 7), ("TranslateYRel", 0.8, 9)],
    [("ShearX", 0.0, 0), ("Solarize", 0.8, 4)],
    [("ShearY", 0.8, 0), ("Color", 0.6, 4)],
    [("Color", 1.0, 0), ("Rotate", 0.6, 2)],
    [("Equalize", 0.8, 4), ("Equalize", 0.0, 8)],
    [("Equalize", 1.0, 4), ("AutoContrast", 0.6, 2)],
    [("ShearY", 0.4, 7), ("SolarizeAdd", 0.6, 7)],
    [("Posterize", 0.8, 2), ("Solarize", 0.6, 10)],
    [("Solarize", 0.6, 8), ("Equalize", 0.6, 1)],
    [("Color", 0.8, 6), ("Rotate", 0.4, 5)],
]

_POLICY_ORIGINAL = [
    [("PosterizeOriginal", 0.4, 8), ("Rotate", 0.6, 9)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
    [("PosterizeOriginal", 0.6, 7), ("PosterizeOriginal", 0.6, 6)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Equalize", 0.4, 4), ("Rotate", 0.8, 8)],
    [("Solarize", 0.6, 3), ("Equalize", 0.6, 7)],
    [("PosterizeOriginal", 0.8, 5), ("Equalize", 1.0, 2)],
    [("Rotate", 0.2, 3), ("Solarize", 0.6, 8)],
    [("Equalize", 0.6, 8), ("PosterizeOriginal", 0.4, 6)],
    [("Rotate", 0.8, 8), ("Color", 0.4, 0)],
    [("Rotate", 0.4, 9), ("Equalize", 0.6, 2)],
    [("Equalize", 0.0, 7), ("Equalize", 0.8, 8)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Rotate", 0.8, 8), ("Color", 1.0, 2)],
    [("Color", 0.8, 8), ("Solarize", 0.8, 7)],
    [("Sharpness", 0.4, 7), ("Invert", 0.6, 8)],
    [("ShearX", 0.6, 5), ("Equalize", 1.0, 9)],
    [("Color", 0.4, 0), ("Equalize", 0.6, 3)],
    [("Equalize", 0.4, 7), ("Solarize", 0.2, 4)],
    [("Solarize", 0.6, 5), ("AutoContrast", 0.6, 5)],
    [("Invert", 0.6, 4), ("Equalize", 1.0, 8)],
    [("Color", 0.6, 4), ("Contrast", 1.0, 8)],
    [("Equalize", 0.8, 8), ("Equalize", 0.6, 3)],
]


def _replace_op(policy, old, new):
    return [[(new if n == old else n, p, m) for (n, p, m) in sp]
            for sp in policy]


_POLICIES = {
    "v0": _POLICY_V0,
    "v0r": _replace_op(_POLICY_V0, "Posterize", "PosterizeIncreasing"),
    "original": _POLICY_ORIGINAL,
    "originalr": _replace_op(_POLICY_ORIGINAL, "PosterizeOriginal",
                             "PosterizeIncreasing"),
}


class AutoAugment:
    """One random sub-policy per clip; each of its ops fires with its
    probability at its fixed magnitude."""

    def __init__(self, policy_name="v0", mag_std=0.0):
        if policy_name not in _POLICIES:
            raise ValueError(f"Unknown AA policy ({policy_name})")
        self.policy_name = policy_name
        self.policy = _POLICIES[policy_name]
        self.mag_std = mag_std

    def __call__(self, frames, rng=None):
        rng = rng or np.random.default_rng()
        sub = self.policy[int(rng.integers(len(self.policy)))]
        for name, prob, mag in sub:
            if rng.uniform() <= prob:
                frames = apply_op(name, frames,
                                  _jitter(mag, self.mag_std, rng), rng)
        return frames


class AugMixAugment:
    """AugMix: ``width`` op chains of random depth, mixed with Dirichlet
    weights, then blended with the original clip by a Beta draw."""

    def __init__(self, magnitude=3, width=3, depth=-1, alpha=1.0,
                 mag_std=float("inf")):
        self.magnitude = magnitude
        self.width = width
        self.depth = depth
        self.alpha = alpha
        self.mag_std = mag_std
        self.ops = list(_AUGMIX_TRANSFORMS)

    def __call__(self, frames, rng=None):
        rng = rng or np.random.default_rng()
        ws = rng.dirichlet([self.alpha] * self.width).astype(np.float32)
        m = float(rng.beta(self.alpha, self.alpha))
        mixed = np.zeros(frames.shape, np.float32)
        for w in ws:
            depth = self.depth if self.depth > 0 else int(rng.integers(1, 4))
            aug = frames
            for _ in range(depth):
                name = self.ops[int(rng.integers(len(self.ops)))]
                aug = apply_op(name, aug,
                               _jitter(self.magnitude, self.mag_std, rng), rng)
            mixed += w * aug.astype(np.float32)
        out = (1 - m) * frames.astype(np.float32) + m * np.clip(mixed, 0, 255)
        return np.clip(out, 0, 255).astype(np.uint8)


def create_auto_augmentation(type_str, crop_size=224, mean=None):
    """The augmentation a ``AUGMENTATION.AUTOAUGMENT.TYPE`` string names:

    - ``rand-m9-mstd0.5-inc1``, ``rand-m7-n4-mstd0.5``: RandAugment;
    - ``v0`` / ``v0r`` / ``original`` / ``originalr`` (+ ``-mstd0.5``):
      AutoAugment;
    - ``augmix-m5-w4-d2`` (+ ``-aA``, alpha): AugMix.
    """
    parts = type_str.split("-")
    kind = parts[0]
    if kind == "rand":
        magnitude, num_ops, mag_std, increasing = 9, 2, 0.5, False
        for p in parts[1:]:
            if p.startswith("mstd"):
                mag_std = float(p[4:])
            elif p.startswith("mmax"):
                pass
            elif p.startswith("m"):
                magnitude = int(p[1:])
            elif p.startswith("n"):
                num_ops = int(p[1:])
            elif p.startswith("inc"):
                increasing = bool(int(p[3:]))
            elif p.startswith("w"):
                pass  # weighted op choice: no shipped recipe uses it
        return RandAugment(magnitude, num_ops, mag_std, increasing)
    if kind == "augmix":
        magnitude, width, depth, alpha, mag_std = 3, 3, -1, 1.0, float("inf")
        for p in parts[1:]:
            if p.startswith("mstd"):
                mag_std = float(p[4:])
            elif p.startswith("m"):
                magnitude = int(p[1:])
            elif p.startswith("w"):
                width = int(p[1:])
            elif p.startswith("d"):
                depth = int(p[1:])
            elif p.startswith("a"):
                alpha = float(p[1:])
        return AugMixAugment(magnitude, width, depth, alpha, mag_std)
    # an AutoAugment policy, e.g. "v0" or "original-mstd0.5"
    mag_std = 0.0
    for p in parts[1:]:
        if p.startswith("mstd"):
            mag_std = float(p[4:])
    return AutoAugment(kind, mag_std)


class RandomErasing:
    """Random erasing of one region of every frame of a clip, filled
    with zeros (``const``), one random value (``rand``) or random values
    (``pixel``)."""

    def __init__(self, prob=0.25, mode="pixel", count=(1, 1),
                 area_range=(0.02, 0.33), min_aspect=0.3):
        self.prob = prob
        self.mode = mode
        self.count = count
        self.area_range = area_range
        self.min_aspect = min_aspect

    def __call__(self, frames, rng=None):
        rng = rng or np.random.default_rng()
        if rng.uniform() >= self.prob:
            return frames
        frames = frames.copy()
        t, h, w, c = frames.shape
        n = int(rng.integers(self.count[0], self.count[1] + 1))
        for _ in range(n):
            for _ in range(10):
                area = rng.uniform(*self.area_range) * h * w
                log_ratio = (np.log(self.min_aspect), np.log(1 / self.min_aspect))
                aspect = np.exp(rng.uniform(*log_ratio))
                eh = int(round(np.sqrt(area * aspect)))
                ew = int(round(np.sqrt(area / aspect)))
                if eh < h and ew < w:
                    y = int(rng.integers(0, h - eh))
                    x = int(rng.integers(0, w - ew))
                    if self.mode == "pixel":
                        fill = rng.integers(0, 256, (t, eh, ew, c), dtype=np.uint8)
                    elif self.mode == "rand":
                        fill = np.full((t, eh, ew, c),
                                       int(rng.integers(0, 256)), np.uint8)
                    else:
                        fill = np.zeros((t, eh, ew, c), np.uint8)
                    frames[:, y:y + eh, x:x + ew] = fill
                    break
        return frames
