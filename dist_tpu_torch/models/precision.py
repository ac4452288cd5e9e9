"""Mixed precision for the conv backbones (port of
``dist_tpu/models/precision.py``).

Under ``TRAIN.MIXED_PRECISION`` the activation dtype carries the policy,
as in the JAX package: the meta-arch casts its input to bf16 once
(:func:`maybe_bf16_input`), each convolution computes in its input's
dtype with its fp32 weights cast for the op (``models/base/blocks.py``'s
``Conv3d``), and BatchNorm runs as an fp32 island (:func:`fp32_island`).
The casts are explicit; ``torch.autocast`` would choose a dtype per op.
"""

import torch


def mixed_precision_enabled(cfg):
    return bool(cfg.TRAIN.get("MIXED_PRECISION", False)
                or cfg.TRAIN.get("HALF_PRECISION", False))


def maybe_bf16_input(cfg, x):
    """A backbone input cast to bf16 when mixed precision is on."""
    if mixed_precision_enabled(cfg) and x.dtype in (torch.float32,
                                                    torch.bfloat16):
        return x.to(torch.bfloat16)
    return x


def island_dtype(x):
    """The dtype of an fp32 island over ``x``: fp32, or float64 for a
    float64 ``x``, so that a model cast to float64 computes in float64
    throughout."""
    return torch.promote_types(x.dtype, torch.float32)


def fp32_island(fn, x):
    """``fn(x)`` computed in fp32 (float64 for a float64 ``x``) and
    returned in ``x``'s dtype."""
    return fn(x.to(island_dtype(x))).to(x.dtype)
