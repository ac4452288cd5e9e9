"""The port's TAda-ConvNeXt (``dist_tpu_torch/models/branches/
tada_convnext.py``) against the JAX package's on the CPU, on seeded JAX
weights (the zero inits, the layer scale and the running stats drawn
too, so that the calibration is away from 1 and every branch counts)
brought across by ``models/backbones/convert.py``:

- ``RouteFuncNeXt`` with the ``normal`` route (flax's BatchNorm,
  momentum 0.99) and the ``normal_lngelu`` route, in eval and in train
  mode: ``w_cal`` and ``b_cal`` within ``TOL``, the running stats after
  a training forward within ``STATS_TOL``; on a bf16 input, fp32 within
  ``TOL``;
- ``TAdaConvNeXtBlock``, ``...AvgPoolGELU`` (zero-init ``avgpool_norm``)
  and ``...AvgPoolGELUOriginal`` (scale 1) on ``(2, 4, 8, 8, 16)``, eval
  and train, fp32 (``TOL``), and eval in bf16 (``BF16_REL``); the
  avg pool counts its padding;
- the ``ConvNeXt`` meta-arch (``tada_convnext_tiny.yaml`` at widths 8,
  16, 32, 64 and depths 1, 1, 2, 1, 4 frames of 64^2) with ``BaseHead``
  on its map, eval and train (scores, features and running stats);
- the initial values: ``avgpool_norm``'s scale 0 or 1 by variant, the
  route's ``b`` and ``b_bias`` 0, ``gamma`` at
  ``LARGE_SCALE_INIT_VALUE``, ``dwconv_bias`` 0."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.base.bn import set_bn_frozen
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.models.branches import tada_convnext as jtc
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.branches import tada_convnext as tc
from dist_tpu_torch.models.backbones.convert import state_dict_from_jax
from tests.test_torch_port_resnet3d import cfgs, load_jax, port_module
from tests.test_torch_port_video_transformer import (
    BF16_REL,
    TOL,
    concrete_linspace,
    module_variables,
    rel,
    variables_of,
)

CONVNEXT = "configs/pool/backbone/tada_convnext_tiny.yaml"
TINY = ["VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64]",
        "VIDEO.BACKBONE.DEPTH", "[1, 1, 2, 1]", "VIDEO.BACKBONE.DROP_PATH",
        "0.0", "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
        "VIDEO.HEAD.NUM_CLASSES", "5"]
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
BLOCKS = ["TAdaConvNeXtBlock", "TAdaConvNeXtBlockAvgPoolGELU",
          "TAdaConvNeXtBlockAvgPoolGELUOriginal"]


def _stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith("running_mean") or k.endswith("running_var")}


def _assert_stats(module, variables, new_stats):
    want = _stats(state_dict_from_jax({**variables, **new_stats}, module))
    got = _stats(module.state_dict())
    assert want and set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k,
                                   **STATS_TOL)


def _apply(jmod, variables, x, train):
    set_bn_frozen(False)
    if train:
        return jmod.apply(variables, x, train=True, mutable=["batch_stats"])
    return jmod.apply(variables, x, train=False), None


def _x(seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (2, 4, 8, 8, 16)).astype(dtype)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("route", ["normal", "normal_lngelu"])
def test_route_func_next_matches_jax(route, train):
    x = _x(40)
    jmod = jtc.RouteFuncNeXt(16, 4, (3, 3), route_type=route,
                             with_bias_cal=True)
    variables = module_variables(jmod, 41, jnp.asarray(x), train=False)
    (want_w, want_b), new_stats = _apply(jmod, variables, jnp.asarray(x),
                                         train)
    mod = load_jax(port_module(tc.RouteFuncNeXt, 16, 4, (3, 3), route, True),
                   variables).train(train)
    with torch.no_grad():
        got_w, got_b = mod(torch.from_numpy(x))
    assert got_w.shape == (2, 4, 1, 1, 16)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)
    assert float(np.abs(np.asarray(want_w) - 1).mean()) > 0.01
    if route == "normal":
        assert mod.bn.momentum == pytest.approx(0.01)
        if train:
            _assert_stats(mod, variables, new_stats)


@pytest.mark.parametrize("route", ["normal", "normal_lngelu"])
def test_route_func_next_takes_bf16_and_computes_fp32(route):
    """A bf16 input (``TRAIN.MIXED_PRECISION``): the means are taken in
    fp32 and the calibration stays fp32, as JAX's, within ``TOL``."""
    x = _x(50)
    jmod = jtc.RouteFuncNeXt(16, 4, (3, 3), route_type=route,
                             with_bias_cal=True)
    variables = module_variables(jmod, 51, jnp.asarray(x), train=False)
    want = jmod.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False)
    mod = load_jax(port_module(tc.RouteFuncNeXt, 16, 4, (3, 3), route, True),
                   variables).eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _block_pair(repo_root, name):
    cfg, jcfg = cfgs(repo_root, CONVNEXT, TINY + [
        "VIDEO.BACKBONE.BRANCH.NAME", name])
    return (getattr(jtc, name)(dim=16, cfg=jcfg),
            port_module(getattr(tc, name), 16, cfg))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", BLOCKS)
def test_convnext_blocks_match_jax(repo_root, name, train):
    x = _x(42)
    jmod, mod = _block_pair(repo_root, name)
    variables = module_variables(jmod, 43 + BLOCKS.index(name),
                                 jnp.asarray(x), train=False)
    want, new_stats = _apply(jmod, variables, jnp.asarray(x), train)
    load_jax(mod, variables).train(train)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if new_stats is not None:
        _assert_stats(mod, variables, new_stats)


@pytest.mark.parametrize("name", BLOCKS)
def test_convnext_blocks_in_bf16_match_jax(repo_root, name):
    """A bf16 input: the depthwise conv and the MLP in bf16, the route
    function in fp32, the LayerNorms fp32 islands, the pool's sum and
    division in bf16 as flax's: each reads 0 on the CPU (the pool
    summed in fp32 and rounded once read 4.2e-3)."""
    x = _x(46)
    jmod, mod = _block_pair(repo_root, name)
    variables = module_variables(jmod, 47, jnp.asarray(x), train=False)
    want = jmod.apply(variables, jnp.asarray(x, jnp.bfloat16), train=False)
    load_jax(mod, variables).eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    assert rel(got.float().numpy(), np.asarray(want, np.float32)) < BF16_REL


@pytest.fixture(scope="module")
def tiny(repo_root):
    """(port cfg, JAX model, JAX variables, clips) of the tiny
    TAda-ConvNeXt with ``BaseHead``."""
    cfg, jcfg = cfgs(repo_root, CONVNEXT, TINY + [
        "VIDEO.BACKBONE.BRANCH.NAME", "TAdaConvNeXtBlockAvgPoolGELU"])
    jmodel = jax_build_model(jcfg)
    clips = np.random.default_rng(48).standard_normal(
        (2, 4, 64, 64, 3)).astype(np.float32)
    variables = variables_of(lambda key: jmodel.init(
        key, {"video": jnp.zeros((1, 4, 64, 64, 3))}), 49)
    return cfg, jmodel, variables, clips


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_convnext_meta_arch_matches_jax(tiny, train):
    """The whole tiny model: scores (eval: softmax; train: logits) and the
    pooled features within ``TOL``; in train mode every route
    function's BatchNorm statistics within ``STATS_TOL``."""
    cfg, jmodel, variables, clips = tiny
    set_bn_frozen(False)
    with concrete_linspace():
        out = jax.jit(lambda v, x: jmodel.apply(
            v, {"video": x}, train=train, return_new_state=True))(
            variables, jnp.asarray(clips))
    want, wfeat, new_stats = out
    model = build_model(cfg, device="cpu")
    load_jax(model.module, variables)
    model.set_mode(train)
    with torch.no_grad():
        got, feat = model.module(torch.from_numpy(clips))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(feat.numpy(), np.asarray(wfeat), **TOL)
    if train:
        _assert_stats(model.module, variables, new_stats)
    else:
        assert new_stats is None


@pytest.mark.parametrize("name,scale", [(BLOCKS[0], None), (BLOCKS[1], 0.0),
                                        (BLOCKS[2], 1.0)])
def test_convnext_initial_values(repo_root, name, scale):
    cfg, _ = cfgs(repo_root, CONVNEXT, TINY + [
        "VIDEO.BACKBONE.BRANCH.NAME", name,
        "VIDEO.BACKBONE.LARGE_SCALE_INIT_VALUE", "0.25"])
    block = build_model(cfg, device="cpu").module.backbone.stage1_block0
    rf = block.dwconv_rf
    with torch.no_grad():
        assert float(rf.b.weight.abs().max()) == 0.0
        assert float(rf.b_bias.weight.abs().max()) == 0.0
        assert torch.equal(block.gamma, torch.full((16,), 0.25))
        assert float(block.dwconv_bias.abs().max()) == 0.0
    if scale is None:
        assert not hasattr(block, "avgpool_norm")
    else:
        assert torch.equal(block.avgpool_norm.weight.detach(),
                           torch.full((16,), scale))
