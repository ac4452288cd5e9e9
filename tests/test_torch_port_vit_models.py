"""The port's whole video transformers against the JAX package's on the
CPU, at the tiny geometry of ``tests/test_torch_port_video_transformer.py``
(width 64, 2 heads, depth 2, 4 frames; patch 8, so that the 32^2 train
crop is a 4 x 4 grid a frame), on seeded JAX weights drawn over the JAX
meta-arch's init tree and brought across by
``models/backbones/convert.py``:

- ``VideoTransformer`` with ``BaseTransformerLayer`` (``vit-s.yaml``)
  and with ``TimesformerLayer`` (``timesformer.yaml``), and
  ``FactorizedTransformer`` (``vivit_fac_enc.yaml``, ``DEPTH_TEMP 1``),
  at the train crop, at 48^2 (the position table grown to 6 x 6) and at
  24^2 (shrunk to 3 x 3) in fp32 (``TOL``);
- the three under ``TRAIN.MIXED_PRECISION`` at 48^2 (``BF16_WHOLE_RATIO``),
  with the norms' output dtypes and eps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_port_resnet3d import cfgs, load_jax, port_module
from tests.test_torch_port_video_transformer import (
    POOL,
    TINY,
    TOL,
    japply,
    module_variables,
    rel,
    run_both,
)
from dist_tpu_torch.models.backbones import video_transformer as vt

# bf16, a whole tiny model: the distance from JAX's bf16 feature within
# this share of the distance of JAX's bf16 feature from its fp32 one
# (0.27 to 0.79 on the CPU: a few bf16 roundings that fall the other
# way grow through the layers, in both packages alike)
BF16_WHOLE_RATIO = 1.0


def model_pair(repo_root, path, opts, seed, crop=32):
    """(port cfg, JAX module, port module, JAX variables) of a backbone,
    the JAX tree drawn over an init at 4 frames of ``crop``."""
    from dist_tpu.models.base.models import BACKBONE_REGISTRY as JREG
    import dist_tpu.models  # noqa: F401
    from dist_tpu_torch.models.base import models as pm

    cfg, jcfg = cfgs(repo_root, path, list(opts))
    jmod = JREG.get_strict(jcfg.VIDEO.BACKBONE.META_ARCH)(cfg=jcfg)
    pm._register_backbones()
    mod = port_module(pm.BACKBONE_REGISTRY.get_strict(
        cfg.VIDEO.BACKBONE.META_ARCH), cfg)
    variables = module_variables(
        jmod, seed, jnp.zeros((1, int(cfg.DATA.NUM_INPUT_FRAMES), crop, crop,
                               3)), train=False)
    return cfg, jmod, mod, variables


CROPS = [32, 48, 24]
MODELS = {"base": (POOL + "vit-s.yaml", []),
          "timesformer": (POOL + "timesformer.yaml", []),
          "factorized": (POOL + "vivit_fac_enc.yaml",
                         ["VIDEO.BACKBONE.DEPTH_TEMP", "1"])}


@pytest.mark.parametrize("crop", CROPS, ids=[f"crop{c}" for c in CROPS])
@pytest.mark.parametrize("model", list(MODELS))
def test_transformers_match_jax_at_three_crops(repo_root, model, crop):
    """``VideoTransformer`` with ``BaseTransformerLayer`` and with
    ``TimesformerLayer``, and ``FactorizedTransformer`` (tubelet 2,
    ``DEPTH_TEMP 1``), trained at 32^2 (4 x 4 patches a frame) and run
    at 32^2, 48^2 (the table grown to 6 x 6) and 24^2 (shrunk to 3 x 3):
    the cls feature in fp32 within ``TOL``."""
    path, opts = MODELS[model]
    cfg, jmod, mod, variables = model_pair(repo_root, path, TINY + opts,
                                           10 + CROPS.index(crop))
    x = np.random.default_rng(crop).standard_normal(
        (2, 4, crop, crop, 3)).astype(np.float32)
    got, want = run_both(jmod, mod, variables, x)
    assert got.shape == (2, 64)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("model", list(MODELS))
def test_transformers_in_mixed_precision_match_jax(repo_root, model):
    """Under ``TRAIN.MIXED_PRECISION`` (bf16 from the stem on) at 48^2:
    the feature's distance from JAX's within ``BF16_WHOLE_RATIO`` of JAX's
    own bf16-to-fp32 distance, and fp32, since the last norm is a plain
    LayerNorm; the factorized encoder's middle ``norm``
    keeps bf16 for the temporal layers, and its ``norm_out`` is fp32."""
    path, opts = MODELS[model]
    cfg, jmod, mod, variables = model_pair(
        repo_root, path, TINY + opts + ["TRAIN.MIXED_PRECISION", "true"], 20)
    jmod32 = model_pair(repo_root, path, TINY + opts, 20)[1]
    x = np.random.default_rng(21).standard_normal(
        (2, 4, 48, 48, 3)).astype(np.float32)
    # JAX's mixed-precision model casts its fp32 input to bf16 itself: op
    # by op, as japply runs a bf16 input
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    want32 = np.asarray(japply(jmod32, variables, jnp.asarray(x)))
    load_jax(mod, variables).eval()
    seen = {}

    def record(name):
        def hook(module, args, out):
            seen[name] = out.dtype
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in mod.named_modules() if name in ("norm", "norm_out")]
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    for h in hooks:
        h.remove()
    assert got.dtype == torch.float32
    want_norm = torch.bfloat16 if model == "factorized" else torch.float32
    assert seen["norm"] == want_norm
    if model == "factorized":
        assert seen["norm_out"] == torch.float32
    assert rel(got.numpy(), want) <= BF16_WHOLE_RATIO * rel(want, want32)
    assert all(m.eps == 1e-6 for m in mod.modules()
               if isinstance(m, vt.LayerNorm))
