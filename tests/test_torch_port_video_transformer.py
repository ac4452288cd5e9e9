"""The port's video transformers (``dist_tpu_torch/models/backbones/
video_transformer.py``) against the JAX package's on the CPU, on the
same seeded inputs and the same seeded JAX weights brought across by
``models/backbones/convert.py``, at the tiny geometry of
``tests/test_video_transformers.py`` (width 64, 2 heads, depth 2, 4
frames of 32^2; patch 8 here, so that a frame is a 4 x 4 grid that the
position-table resize grows to 6 x 6 at 48^2 and shrinks to 3 x 3 at
24^2):

- ``DropPath``: the mask's statistics, its scale, per-sample broadcast,
  the explicit generator, the eval and rate-0 identity;
- the stems, ``_Attention`` (joint and divided), ``_FeedForward``,
  ``BaseTransformerLayer`` and ``TimesformerLayer`` alone, in fp32
  (``TOL``) and in bf16 (relative L2 within ``BF16_REL``); in bf16 the
  port's attention rounds the scale and ``q * scale`` to bf16 as JAX
  does, which ``F.scaled_dot_product_attention`` does not (19 to 26
  times farther from JAX, ``test_bf16_attention_rounds_as_jax``);
- divided attention's group isolation and its batch-major cls k/v;
- the position-table resize against ``jax.image.resize`` growing and
  shrinking (``RESIZE_TOL``), and ``F.interpolate`` beside it;
- the ``TUBELET_SIZE`` defaults of the stems, the layer and the
  factorized encoder.

The weights are drawn over the JAX module's ``init`` tree
(``jax.eval_shape``, no init run): kernels N(0, fan_in^-1/2), LayerNorm
scales in [0.5, 1.5), biases N(0, 0.1), the tokens and tables N(0, 0.5),
so that no part of the path is near the identity.
The whole backbones are held in ``tests/test_torch_port_vit_models.py``;
it, ``_vit_video.py``, ``_tada_convnext.py`` and ``_vit_train.py``
import the helpers here."""

import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dist_tpu.models.backbones import video_transformer as jvt
from dist_tpu_torch.models.backbones import video_transformer as vt
from tests.test_torch_port_resnet3d import cfgs, load_jax, port_module

TOL = dict(atol=2e-5, rtol=1e-4)
# bf16, a module: the relative L2 distance from JAX's bf16 output; the
# readings on the CPU are 0 (the stems, the FFN, the joint layer) to
# 2.6e-4 (the attention: its fp32 softmax rounds to bf16 a little
# differently), 4 times that
BF16_REL = 1e-3
# the resize's weights are computed in float64 here and in fp32 by JAX
RESIZE_TOL = dict(atol=1e-6, rtol=1e-6)
POOL = "configs/pool/backbone/"
TINY = ["VIDEO.HEAD.NUM_CLASSES", "5", "DATA.NUM_INPUT_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "VIDEO.BACKBONE.NUM_FEATURES", "64",
        "VIDEO.BACKBONE.NUM_HEADS", "2", "VIDEO.BACKBONE.DEPTH", "2",
        "VIDEO.BACKBONE.PATCH_SIZE", "8", "VIDEO.BACKBONE.DROP_PATH", "0.0"]


def draw(path, shape, rng):
    """A seeded value for the JAX leaf at ``path``."""
    name = path[-1]
    if name == "kernel":
        return rng.normal(0.0, int(np.prod(shape[:-1])) ** -0.5, shape)
    if name == "scale":
        return rng.uniform(0.5, 1.5, shape)
    if name in ("bias", "mean", "dwconv_bias"):
        return rng.normal(0.0, 0.1, shape)
    if name == "var":
        return rng.uniform(0.5, 2.0, shape)
    if name == "gamma":
        return rng.uniform(0.5, 1.5, shape)
    if name in ("cls_token", "cls_token_out", "pos_embd", "temp_embd",
                "mask_token"):
        return rng.normal(0.0, 0.5, shape)
    raise KeyError("/".join(path))


@contextlib.contextmanager
def concrete_linspace():
    """``jnp.linspace`` on concrete bounds as numpy's in fp32 inside the
    block. The JAX meta-archs call ``float`` on ``jnp.linspace`` (their
    stochastic-depth rates) while they trace, which a traced
    ``jnp.linspace`` refuses: no jit or ``eval_shape`` of them runs
    without this (``ROADMAP.md`` C). ``jax.ensure_compile_time_eval``
    would do too, at ~20 s of compiles of the initialisers' constants."""
    orig = jnp.linspace

    def linspace(start, stop, num=50, **kwargs):
        if isinstance(start, (int, float)) and isinstance(stop, (int, float)):
            return np.linspace(start, stop, num, dtype=np.float32)
        return orig(start, stop, num, **kwargs)

    jnp.linspace = linspace
    try:
        yield
    finally:
        jnp.linspace = orig


def variables_of(init, seed):
    """Seeded numpy variables over the tree that ``init(key)`` (a JAX init
    call) would give, without running it."""
    with concrete_linspace():
        shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = tuple(str(getattr(p, "key", p)) for p in path)
        return draw(keys, s.shape, rng).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def module_variables(jmod, seed, *args, **kwargs):
    return variables_of(lambda key: jmod.init(key, *args, **kwargs), seed)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def japply(jmod, variables, x, **kwargs):
    """``jmod.apply(variables, x, train=False, **kwargs)``: jitted in fp32
    (under ``concrete_linspace``), op by op in bf16, where XLA's fusion
    would keep some of the program's bf16 roundings in fp32."""
    if x.dtype == jnp.bfloat16:
        return jmod.apply(variables, x, train=False, **kwargs)
    with concrete_linspace():
        return jax.jit(lambda v, a: jmod.apply(v, a, train=False, **kwargs))(
            variables, x)


def run_both(jmod, mod, variables, x, dtype=jnp.float32, **kwargs):
    """(port output, JAX output) as fp32 numpy on ``x`` cast to
    ``dtype``, eval mode."""
    want = japply(jmod, variables, jnp.asarray(x, dtype), **kwargs)
    load_jax(mod, variables).eval()
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(tdtype), **kwargs)
    assert got.dtype == tdtype
    return got.float().numpy(), np.asarray(want, np.float32)


def assert_close(got, want, dtype):
    if dtype == jnp.float32:
        np.testing.assert_allclose(got, want, **TOL)
    else:
        assert rel(got, want) < BF16_REL


DTYPES = [jnp.float32, jnp.bfloat16]
DTYPE_IDS = ["fp32", "bf16"]


def test_drop_path_mask_statistics_and_scale():
    """At rate 0.25 a sample's branch is kept whole or dropped whole,
    kept 3 times in 4 (within 4 standard deviations over 20000 samples),
    scaled by 4/3; the same generator seed draws the same mask; in eval
    mode and at rate 0 the identity."""
    dp = vt.DropPath(0.25).train()
    dp.generator = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 3, 5)
    y = dp(x)
    per_sample = y.reshape(20000, -1)
    assert torch.equal(per_sample.min(1).values, per_sample.max(1).values)
    vals = set(np.unique(y.numpy()).tolist())
    assert vals == {0.0, np.float32(1 / 0.75)}
    kept = float((per_sample[:, 0] > 0).float().mean())
    assert abs(kept - 0.75) < 4 * (0.75 * 0.25 / 20000) ** 0.5
    dp.generator = torch.Generator().manual_seed(0)
    assert torch.equal(dp(x), y)
    assert torch.equal(dp.eval()(x), x)
    assert vt.DropPath(0.0).train()(x) is x
    # the port's rates: linspace(0, DROP_PATH, depth) as JAX's
    np.testing.assert_allclose(vt.drop_rates(0.1, 12),
                               [float(r) for r in jnp.linspace(0, 0.1, 12)],
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("stem", ["PatchEmbedStem", "TubeletEmbeddingStem"])
def test_stems_match_jax(repo_root, stem, dtype):
    cfg, jcfg = cfgs(repo_root, POOL + "vivit.yaml", TINY)
    x = np.random.default_rng(1).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    jmod = getattr(jvt, stem)(jcfg)
    variables = module_variables(jmod, 2, jnp.asarray(x))
    got, want = run_both(jmod, port_module(getattr(vt, stem), cfg),
                         variables, x, dtype)
    assert got.shape == (2, 4 // (2 if stem[0] == "T" else 1) * 16, 64)
    assert_close(got, want, dtype)


def _tokens(seed, b=2, f=4, n=16, dim=64):
    return np.random.default_rng(seed).standard_normal(
        (b, 1 + f * n, dim)).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("groups", [None, 4], ids=["joint", "divided"])
def test_attention_matches_jax(groups, dtype):
    """Both forms on 2 clips of 1 + 4 x 16 tokens; the divided one in 4
    groups of 16 (batch 2: the cls token's k and v go to each clip's own
    groups)."""
    x = _tokens(3)
    kw = {} if groups is None else dict(groups=4, group_size=16)
    jmod = jvt._Attention(64, 2)
    variables = module_variables(jmod, 4, jnp.asarray(x), **kw)
    got, want = run_both(jmod, port_module(vt._Attention, 64, 2), variables,
                         x, dtype, **kw)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dim", [64, 128], ids=["hd32", "hd64"])
def test_bf16_attention_rounds_as_jax(dim):
    """In bf16 the port's attention (the scale and ``q * scale`` rounded
    to bf16, fp32 scores and softmax) is the JAX package's: relative L2
    2.1e-4 at head dim 32 and 1.4e-4 at head dim 64 (ViT-S's), where the
    same math through ``F.scaled_dot_product_attention`` reads 4.0e-3 and
    3.5e-3. The port must stay within ``BF16_REL`` and at most a tenth of
    SDPA's distance."""
    x = _tokens(5, dim=dim)
    jmod = jvt._Attention(dim, 2)
    variables = module_variables(jmod, 6, jnp.asarray(x))
    mod = port_module(vt._Attention, dim, 2)
    got, want = run_both(jmod, mod, variables, x, jnp.bfloat16)

    def sdpa(q, k, v, scale, dropout=0.0):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale).transpose(1, 2)

    orig, vt.attend = vt.attend, sdpa
    try:
        with torch.no_grad():
            other = mod(torch.from_numpy(x).bfloat16()).float().numpy()
    finally:
        vt.attend = orig
    assert rel(got, want) < BF16_REL
    assert rel(got, want) <= 0.1 * rel(other, want)


def test_divided_attention_isolates_its_groups():
    """A patch token's output does not move when a token of another group
    moves, and moves with one of its own group or the cls token; the cls
    token's output moves with any token. With batch 2, the second clip's
    groups see the second clip's cls k and v (``repeat_interleave``)."""
    x = torch.from_numpy(_tokens(7))
    mod = port_module(vt._Attention, 64, 2)
    from dist_tpu_torch.models.base.blocks import init_weights
    init_weights(mod, torch.Generator().manual_seed(0))
    with torch.no_grad():
        base = mod(x, groups=4, group_size=16)
        other = x.clone()
        other[:, 1 + 16 * 2 + 5] += 3.0       # group 2's token 5
        moved = mod(other, groups=4, group_size=16)
        own = x.clone()
        own[:, 1 + 3] += 3.0                  # group 0's token 3
        moved_own = mod(own, groups=4, group_size=16)
        cls = x.clone()
        cls[1, 0] += 3.0                      # clip 1's cls token
        moved_cls = mod(cls, groups=4, group_size=16)
    diff = (moved - base).abs().amax(-1)
    assert float(diff[:, 1:33].max()) == 0.0
    assert float(diff[:, 49:].max()) == 0.0
    assert float(diff[:, 0].min()) > 0 and float(diff[:, 33:49].min()) > 0
    assert float((moved_own - base).abs().amax(-1)[:, 1:17].min()) > 0
    dcls = (moved_cls - base).abs().amax(-1)
    assert float(dcls[0].max()) == 0.0 and float(dcls[1].min()) > 0


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", ["_FeedForward", "BaseTransformerLayer",
                                  "TimesformerLayer"])
def test_ffn_and_layers_match_jax(repo_root, name, dtype):
    """The FFN (exact GELU) and both layers on 2 clips of 1 + 4 x 16
    tokens; ``TimesformerLayer`` groups by the token count (16 patches a
    frame, not the train crop's)."""
    cfg, jcfg = cfgs(repo_root, POOL + "timesformer.yaml", TINY)
    x = _tokens(8)
    if name == "_FeedForward":
        jmod, mod = jvt._FeedForward(64), port_module(vt._FeedForward, 64)
    else:
        jmod = getattr(jvt, name)(jcfg)
        mod = port_module(getattr(vt, name), cfg)
    variables = module_variables(jmod, 9, jnp.asarray(x))
    got, want = run_both(jmod, mod, variables, x, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("sides", [(4, 6), (7, 8), (4, 3), (8, 7)],
                         ids=["grow-4-6", "grow-7-8", "shrink-4-3",
                              "shrink-8-7"])
def test_position_table_resize_matches_jax(sides):
    """``resize_grid`` against ``jax.image.resize(..., "bilinear")`` (half-
    pixel centres; antialiased when shrinking) in both directions, ViT-S's
    7 -> 8 (112^2 to 128^2) among them. ``F.interpolate(bilinear,
    align_corners=False)`` agrees when growing and not when shrinking,
    where JAX widens its kernel."""
    s0, s1 = sides
    grid = np.random.default_rng(s0 * 10 + s1).standard_normal(
        (3, s0, s0, 16)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(grid), (3, s1, s1, 16),
                                       "bilinear"))
    got = vt.resize_grid(torch.from_numpy(grid), s1).numpy()
    np.testing.assert_allclose(got, want, **RESIZE_TOL)
    interp = F.interpolate(torch.from_numpy(grid).permute(0, 3, 1, 2),
                           size=(s1, s1), mode="bilinear",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    if s1 > s0:
        np.testing.assert_allclose(interp, want, **RESIZE_TOL)
    else:
        assert np.abs(interp - want).max() > 1e-2


def test_tubelet_size_defaults_follow_jax(repo_root):
    """Without ``TUBELET_SIZE`` the tubelet stem takes 2 frames, while
    ``TimesformerLayer`` and ``FactorizedTransformer`` count frames with
    1, as the JAX package's defaults (the JAX trees' shapes: the stem's
    kernel and the factorized ``temp_embd``)."""
    cfg, jcfg = cfgs(repo_root, POOL + "vit-s.yaml", TINY + [
        "VIDEO.BACKBONE.STEM.NAME", "TubeletEmbeddingStem"])
    assert "TUBELET_SIZE" not in cfg.VIDEO.BACKBONE
    stem = port_module(vt.TubeletEmbeddingStem, cfg)
    assert stem.conv1.weight.shape[2] == 2 == stem.tubelet
    assert port_module(vt.TimesformerLayer, cfg).frames == 4
    fac = port_module(vt.FactorizedTransformer, cfg)
    assert fac.tubelet == 1 and fac.temp_embd.shape == (1, 5, 64)
    shapes = jax.eval_shape(lambda: jvt.TubeletEmbeddingStem(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3))))
    assert shapes["params"]["conv1"]["kernel"].shape[0] == 2
