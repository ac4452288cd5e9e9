"""The train step's augmentation on the video's device (port of
``dist_tpu/ops/augment_device.py``; ``AUGMENTATION.USE_GPU``).

On ``[0, 1]`` float video ``(N, T, H, W, C)``: a horizontal flip per row,
the clip-consistent colour jitter per row (brightness, contrast,
saturation, the HSV hue shift, each row's jitter gated by ``color_p``)
and a grayscale per row after it, and the separable Gaussian blur with a
sigma per row, applied with probability ``blur_p``. Plain torch ops on
the video's device, as the JAX package's are plain jnp: no kernel.

Each op is split into a draw and an apply. :func:`draw` takes every
random factor of a batch from a CPU ``torch.Generator`` (the train step
seeds it from (seed, step) with ``tasks/state.py::step_generator``), so
that the card and the CPU see the same factors; :func:`apply` (and each
op's ``apply_*``) takes the video and the factors. The tests feed the
apply the factors the JAX package draws with ``jax.random``.
"""

import dataclasses

import torch

_RGB2GRAY = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class DeviceAugConfig:
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    hue: float = 0.0
    grayscale: float = 0.0
    flip: float = 0.5
    color_p: float = 0.8
    blur_p: float = 0.0
    blur_sigma: float = 1.0

    @classmethod
    def from_cfg(cls, cfg):
        """The host path's gates, moved: colour jitter only under
        ``COLOR_AUG`` or the SSL gate ``AUGMENTATION.COLOR`` (its
        probability), and not where AutoAugment takes its place; SSV2 never
        flips here, since its direction-sensitive labels must be remapped
        with the flip, which only the host path does."""
        aug = cfg.AUGMENTATION
        flip = 0.5
        if "ssv2" in str(cfg.TRAIN.get("DATASET", "")).lower():
            flip = 0.0
        color_p = aug.get("COLOR")
        ssl_color = color_p is not None
        if color_p is None:
            color_p = aug.get("COLOR_JITTER_P", 0.8)
        autoaug = bool(aug.AUTOAUGMENT.ENABLE) if aug.get("AUTOAUGMENT") \
            else False
        color_on = (ssl_color or bool(aug.get("COLOR_AUG", False))) \
            and not autoaug
        blur_p = float(aug.get("BLUR", 0.0) or 0.0)
        if not color_on:
            return cls(color_p=0.0, flip=flip, blur_p=blur_p)
        return cls(brightness=float(aug.BRIGHTNESS),
                   contrast=float(aug.CONTRAST),
                   saturation=float(aug.SATURATION), hue=float(aug.HUE),
                   grayscale=float(aug.GRAYSCALE),
                   color_p=float(color_p or 0.0), blur_p=blur_p, flip=flip)

    @property
    def jitter(self):
        return bool(self.brightness or self.contrast or self.saturation
                    or self.hue or self.grayscale)


# --------------------------------------------------------------------------
# draws: CPU tensors, one entry a row


def draw(c, rows, generator):
    """Every factor of a batch of ``rows`` rows from the CPU
    ``generator``: "flip" (bool); with a jitter "color" (bool), the
    factors "brightness", "contrast", "saturation" (float32 in [max(0, 1 -
    s), 1 + s]), "hue" (in [-hue, hue]) and "gray" (bool); with a blur
    "sigma" (in [0.1, 2 blur_sigma]) and "blur" (bool)."""
    def uniform(lo, hi):
        u = torch.rand(rows, generator=generator, dtype=torch.float32)
        return lo + (hi - lo) * u

    def chance(p):
        return torch.rand(rows, generator=generator) < p

    out = {"flip": chance(c.flip)}
    if c.jitter:
        out.update(
            color=chance(c.color_p),
            brightness=uniform(max(0.0, 1 - c.brightness), 1 + c.brightness),
            contrast=uniform(max(0.0, 1 - c.contrast), 1 + c.contrast),
            saturation=uniform(max(0.0, 1 - c.saturation), 1 + c.saturation),
            hue=uniform(-c.hue, c.hue), gray=chance(c.grayscale))
    if c.blur_p > 0:
        out.update(sigma=uniform(0.1, 2.0 * c.blur_sigma),
                   blur=chance(c.blur_p))
    return out


# --------------------------------------------------------------------------
# applies: the video (N, T, H, W, C) in [0, 1] and the factors


def _rows(f, video):
    """A row factor on the video's device, shaped to broadcast over
    (N, T, H, W, C)."""
    return f.to(video.device, non_blocking=True).view(-1, 1, 1, 1, 1)


def _gray(x):
    w = torch.tensor(_RGB2GRAY, dtype=x.dtype, device=x.device)
    return x @ w


def rgb2hsv(x):
    """RGB -> (h, s, v) on float (..., 3) in [0, 1], the JAX package's
    vectorised formula."""
    r, g, b = x.unbind(-1)
    maxc = x.amax(dim=-1)
    minc = x.amin(dim=-1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc = (maxc - r) / cr_div
    gc = (maxc - g) / cr_div
    bc = (maxc - b) / cr_div
    h = ((maxc == r) * (bc - gc)
         + ((maxc == g) & (maxc != r)) * (2.0 + rc - bc)
         + ((maxc != g) & (maxc != r)) * (4.0 + gc - rc))
    h = torch.remainder(h / 6.0 + 1.0, 1.0)
    return h, s, maxc


def hsv2rgb(h, s, v):
    """(h, s, v) -> RGB (..., 3), each channel chosen by the sextant."""
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = (i.to(torch.int32) % 6).long()[..., None]
    p = (v * (1.0 - s)).clamp(0.0, 1.0)
    q = (v * (1.0 - s * f)).clamp(0.0, 1.0)
    t = (v * (1.0 - s * (1.0 - f))).clamp(0.0, 1.0)
    r = torch.gather(torch.stack([v, q, p, p, t, v], dim=-1), -1, i)
    g = torch.gather(torch.stack([t, v, v, q, p, p], dim=-1), -1, i)
    b = torch.gather(torch.stack([p, p, t, v, v, q], dim=-1), -1, i)
    return torch.cat([r, g, b], dim=-1)


def apply_hflip(video, flip):
    """Rows with ``flip`` reversed along W."""
    return torch.where(_rows(flip, video), video.flip(3), video)


def apply_color_jitter(video, f, c):
    """Brightness, then contrast about each frame's mean luma, then
    saturation about each pixel's luma, then (``c.hue``) the hue shift, on
    the rows with ``f["color"]``; then grayscale on the rows with
    ``f["gray"]``; clipped to [0, 1]."""
    y = (video * _rows(f["brightness"], video)).clamp(0.0, 1.0)
    mean = _gray(y).mean(dim=(2, 3))[..., None, None, None]
    y = ((y - mean) * _rows(f["contrast"], video) + mean).clamp(0.0, 1.0)
    gray = _gray(y)[..., None]
    y = ((y - gray) * _rows(f["saturation"], video) + gray).clamp(0.0, 1.0)
    if c.hue:
        hh, ss, vv = rgb2hsv(y)
        shift = f["hue"].to(video.device, non_blocking=True).view(-1, 1, 1, 1)
        y = hsv2rgb(torch.remainder(hh + shift, 1.0), ss, vv)
    y = torch.where(_rows(f["color"], video), y, video)
    y = torch.where(_rows(f["gray"], video), _gray(y)[..., None].expand_as(y),
                    y)
    return y.clamp(0.0, 1.0)


def _conv_axis(x, kern, dim):
    """``x`` convolved along ``dim`` with a 1-D kernel a row (``kern``
    (M, k)), edges padded by repetition, the taps summed in order."""
    k = kern.shape[1]
    n = x.shape[dim]
    idx = torch.arange(-(k // 2), n + k // 2, device=x.device).clamp(0, n - 1)
    xp = x.index_select(dim, idx)
    shape = (-1,) + (1,) * (x.dim() - 1)
    out = None
    for i in range(k):
        term = kern[:, i].view(shape) * xp.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def apply_gaussian_blur(video, f, c):
    """The separable Gaussian blur of the rows with ``f["blur"]`` (over H,
    then W), each with its ``f["sigma"]``; the kernel
    ``exp(-x^2 / (2 sigma^2))`` normalised, its taps about a tenth of the
    short side (odd, at least 3)."""
    if c.blur_p <= 0:
        return video
    picked = f["blur"].nonzero().flatten()
    if picked.numel() == 0:
        return video
    n, _, h, w, _ = video.shape
    half = max((min(h, w) // 10) | 1, 3) // 2
    offs = torch.arange(-half, half + 1, dtype=video.dtype,
                        device=video.device)
    sigma = f["sigma"][picked].to(video.device, video.dtype)[:, None]
    kern = torch.exp(-(offs ** 2) / (2 * sigma ** 2))
    kern = kern / kern.sum(dim=1, keepdim=True)
    picked = picked.to(video.device)
    x = video.index_select(0, picked)
    x = _conv_axis(_conv_axis(x, kern, 2), kern, 3)
    return video.index_copy(0, picked, x)


def apply(video, f, c):
    """The chain: flip, colour jitter (when any of its strengths is set),
    blur."""
    video = apply_hflip(video, f["flip"])
    if c.jitter:
        video = apply_color_jitter(video, f, c)
    return apply_gaussian_blur(video, f, c)
