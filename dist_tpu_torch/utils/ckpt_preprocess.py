"""Cross-architecture checkpoint adaptation (port of
``dist_tpu/utils/ckpt_preprocess.py``), on torch state dicts: flat
{name: tensor} with the reference's key names and layouts.

- :func:`inflate_2d_to_3d`: I3D-style 2D -> 3D conv inflation. A 2D
  kernel ``(O, I, H, W)`` meeting a 3D template ``(O, I, T, H, W)`` is
  repeated over T and divided by T.
- :func:`preprocess_params`: the reference's positional-embedding repeat
  or super-resolution (``pos_embd`` ``(1, N + 1, C)``, with the temporal
  ``temp_embd`` interpolated) and the tubelet init of the patch stem
  (``stem.conv1.weight`` ``(O, I, T, H, W)``), by key suffix.

The JAX package resizes a grid with OpenCV; the card's machine has none,
so :func:`_bilinear_resize_grid` uses ``F.interpolate`` with OpenCV's
``INTER_LINEAR`` sampling (pixel centres, no antialias).
"""

import math

import torch
import torch.nn.functional as F

from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def inflate_2d_to_3d(sd_2d, template):
    """``template``'s entries, each replaced by the same-named entry of
    ``sd_2d`` where the shapes agree, or by its inflation where a 4-D
    kernel meets a 5-D one; entries missing from ``sd_2d`` or of another
    shape keep the template's value."""
    out = {}
    for name, tpl in template.items():
        src = sd_2d.get(name)
        if src is None:
            out[name] = tpl
            continue
        src = torch.as_tensor(src)
        if src.dim() == 4 and tpl.dim() == 5:
            if tuple(src.shape[2:]) != tuple(tpl.shape[3:]) or \
                    tuple(src.shape[:2]) != tuple(tpl.shape[:2]):
                raise ValueError(f"{name}: cannot inflate {tuple(src.shape)} "
                                 f"to {tuple(tpl.shape)}")
            t = tpl.shape[2]
            logger.info("Inflate %s: %s -> %s", name, tuple(src.shape),
                        tuple(tpl.shape))
            out[name] = src.unsqueeze(2).repeat(1, 1, t, 1, 1) / t
        elif tuple(src.shape) == tuple(tpl.shape):
            out[name] = src
        else:
            logger.info("Unexpected %s: %s -|> %s", name, tuple(src.shape),
                        tuple(tpl.shape))
            out[name] = tpl
    return out


def _bilinear_resize_grid(pos, side_new):
    """(N, C) square pos-embed grid -> (side_new ** 2, C), bilinear with
    OpenCV's pixel-centre sampling, in float32."""
    n, c = pos.shape
    side = math.isqrt(n)
    grid = pos.float().reshape(side, side, c).permute(2, 0, 1)[None]
    out = F.interpolate(grid, size=(side_new, side_new), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).reshape(side_new * side_new, c)


def _resize_pos(cfg, name, pe):
    """``TRAIN.CHECKPOINT_PRE_PROCESS.POS_EMBED`` on one (1, N + 1, C)
    spatial pos-embed."""
    mode = cfg.TRAIN.CHECKPOINT_PRE_PROCESS.get("POS_EMBED") or None
    _, n, c = pe.shape
    if mode == "repeat":
        f = int(cfg.DATA.NUM_INPUT_FRAMES)
        ts = cfg.VIDEO.BACKBONE.get("TUBELET_SIZE")
        if ts:
            f //= int(ts)
        body = pe[:, 1:].unsqueeze(1).repeat(1, f, 1, 1).reshape(
            1, f * (n - 1), c)
        logger.info("Repeated positional embedding x%d (%s).", f, name)
        return torch.cat([pe[:, :1], body], dim=1)
    if mode == "super-resolution":
        side_new = int(cfg.DATA.TRAIN_CROP_SIZE) // int(
            cfg.VIDEO.BACKBONE.PATCH_SIZE)
        side_old = math.isqrt(n - 1)
        if side_new != side_old:
            body = _bilinear_resize_grid(pe[0, 1:], side_new).to(pe.dtype)
            logger.info("Pos-embed super-resolution %d -> %d (%s).",
                        side_old, side_new, name)
            return torch.cat([pe[:, :1], body[None]], dim=1)
    return pe


def _interp_temporal(cfg, name, te):
    """Linear interpolation of a (1, T + 1, C) temporal embedding to the
    configured number of tubelets (super-resolution mode)."""
    t_new = int(cfg.DATA.NUM_INPUT_FRAMES) // int(
        cfg.VIDEO.BACKBONE.TUBELET_SIZE)
    t_old = te.shape[1] - 1
    if t_new == t_old:
        return te
    body = te[0, 1:].double()
    xs = torch.linspace(0, t_old - 1, t_new, dtype=torch.float64)
    lo = xs.floor().long()
    hi = (lo + 1).clamp(max=t_old - 1)
    w = (xs - lo)[:, None]
    interp = body[lo] * (1 - w) + body[hi] * w
    logger.info("Temp-embed interpolation %d -> %d (%s).", t_old, t_new, name)
    return torch.cat([te[:, :1], interp[None].to(te.dtype)], dim=1)


def _tubelet_init(cfg, name, w, mode):
    """A stem kernel (O, I, 1, H, W) of a 2D checkpoint as (O, I, TS, H,
    W): the central frame holds it (``central_frame``) or every frame a
    TS-th of it (``average``)."""
    ts = int(cfg.VIDEO.BACKBONE.TUBELET_SIZE)
    if mode == "central_frame":
        out = torch.zeros(w.shape[:2] + (ts,) + w.shape[3:], dtype=w.dtype)
        out[:, :, ts // 2] = w[:, :, 0]
        logger.info("Central-frame tubelet init (ts=%d, %s).", ts, name)
        return out
    logger.info("Average tubelet init (ts=%d, %s).", ts, name)
    return w[:, :, :1].repeat(1, 1, ts, 1, 1) / float(ts)


def preprocess_params(cfg, sd):
    """``TRAIN.CHECKPOINT_PRE_PROCESS`` applied to a state dict: every
    ``*pos_embd`` (and, under super-resolution, ``*temp_embd``) and every
    ``*stem.conv1.weight``. Returns a new dict."""
    pp = cfg.TRAIN.CHECKPOINT_PRE_PROCESS
    pos_mode = pp.get("POS_EMBED") or None
    patch_mode = pp.get("PATCH_EMBED") or pp.get("PATCH_EMBD") or None
    out = dict(sd)
    for name, v in sd.items():
        v = torch.as_tensor(v)
        if pos_mode and name.endswith("pos_embd"):
            out[name] = _resize_pos(cfg, name, v)
        elif pos_mode == "super-resolution" and name.endswith("temp_embd"):
            out[name] = _interp_temporal(cfg, name, v)
        elif patch_mode in ("central_frame", "average") and \
                name.endswith("stem.conv1.weight") and v.dim() == 5:
            out[name] = _tubelet_init(cfg, name, v, patch_mode)
    return out
