"""The port's SlowFast (``dist_tpu_torch/models/backbones/slowfast.py``)
against the JAX package's on the CPU, fp32, on seeded JAX weights brought
across by ``models/backbones/convert.py`` (the helpers of
``tests/test_torch_port_resnet3d.py`` and ``_tada.py``: running stats
calibrated near the data's, so that the deep eval forward stays in
range):

- a tiny SlowFast R50 (the geometry of
  ``tests/test_more_backbones.py::_tiny_slowfast_cfg``: NUM_FILTERS [32,
  32, 64, 128, 256], fusion kernel 5, 8 frames, at 64^2: at 32^2 the
  last stage's 1 x 1 maps give BatchNorm statistics of 4 values, and fp32
  rounding then grows 50-fold a stage, while both packages in float64
  agree within 5e-11) whole with
  ``SlowFastHead``, in ``slowfast``, ``slowonly`` and ``fastonly`` modes,
  in eval (scores at ``atol=2e-4, rtol=1e-4``, pooled features at
  ``FEAT_TOL``) and in train mode (logits at ``TRAIN_TOL`` and every
  updated running stat at ``STATS_TOL``); and with ``SlowFastHeadx2``;
- ``FuseFastToSlow`` alone (with the fusion conv's bias), eval and train;
- the bottleneck's ``(3, 1, 1)`` conv ``a`` under
  ``TEMPORAL_CONV_BOTTLENECK`` whatever ``KERNEL_SIZE`` says;
- ``slowfast_ek100.yaml`` at full width on the meta device: every entry
  of the port's state dict maps onto one JAX leaf at its shape and back,
  and the config builds on the CPU; the engine serves it with
  ``SlowFastHead``. ``tests/test_torch_port_s3dg.py`` and
  ``_epic_step.py`` import the helpers here."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.backbones import slowfast as js
from dist_tpu.models.base.bn import set_bn_frozen
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu_torch.models.backbones import slowfast as ps
from dist_tpu_torch.models.backbones.convert import state_dict_from_jax
from dist_tpu_torch.models.base import models as pm
from dist_tpu_torch.tasks.state import _prep_video
from tests.test_torch_port_resnet3d import (
    TOL,
    assert_tree_maps_one_to_one,
    cfgs,
    from_ncdhw,
    jax_variables,
    load_jax,
    port_module,
    to_ncdhw,
)
from tests.test_torch_port_tada import _calibrate, _stats

SF = "configs/projects/tada/slowfast_ek100.yaml"
TINY = ["VIDEO.BACKBONE.NUM_FILTERS", "[32, 32, 64, 128, 256]",
        "VIDEO.BACKBONE.KERNEL_SIZE",
        "[[[1, 7, 7], [1, 3, 3], [1, 3, 3], [1, 3, 3], [1, 3, 3]], "
        "[[5, 7, 7], [3, 3, 3], [3, 3, 3], [3, 3, 3], [3, 3, 3]]]",
        "VIDEO.BACKBONE.SLOWFAST.KERNEL_SIZE", "5",
        "DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "64",
        "DATA.TEST_CROP_SIZE", "64", "VIDEO.HEAD.DROPOUT_RATE", "0.0",
        "LOG_MODEL_INFO", "false"]
MODES = ["slowfast", "slowonly", "fastonly"]
# the pooled features, fp32 (tests/test_torch_port_tada.py's limit)
FEAT_TOL = dict(atol=1e-3, rtol=1e-3)
# train-mode logits: batch statistics over 2 clips amplify the rounding
# of 16 blocks
TRAIN_TOL = dict(atol=1e-3, rtol=1e-3)
# a training forward's running stats: deep layers carry the rounding of
# the layers before them
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def head_opts(head, classes):
    return ["VIDEO.HEAD.NAME", head, "VIDEO.HEAD.NUM_CLASSES", classes]


def tiny_model(repo_root, path, opts, clips, seed):
    """(port cfg, JAX cfg, JAX model, seeded JAX variables with running
    stats calibrated on ``clips``, the port model with them)."""
    cfg, jcfg = cfgs(repo_root, path, opts)
    jmodel = jax_build_model(jcfg)
    variables = jax_variables(jmodel, seed, {"video": jnp.zeros(
        clips.shape, jnp.float32)})
    model = pm.build_model(cfg, device="cpu")
    load_jax(model.module, variables)
    _calibrate(model.module, _prep_video(cfg, torch.from_numpy(clips)),
               variables, np.random.default_rng(seed))
    return cfg, jcfg, jmodel, variables, model


def run_both(cfg, jmodel, variables, model, clips, train):
    """((JAX preds, JAX features, JAX new stats or None), (port preds,
    port features)) on ``clips``, with ``train`` the mode; the port's
    running stats move in train mode."""
    video = _prep_video(cfg, torch.from_numpy(clips))
    x = jnp.asarray(video.numpy())
    set_bn_frozen(False)
    if train:
        want = jax.jit(lambda v, x: jmodel.apply(
            v, {"video": x}, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
            return_new_state=True))(variables, x)
    else:
        want = jax.jit(lambda v, x: jmodel.apply(
            v, {"video": x}, train=False))(variables, x) + (None,)
    with torch.set_grad_enabled(train):
        got = model.apply({"video": video}, train=train)
    return want, got


def assert_preds(got, want, tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(want[k]), err_msg=k, **tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)


def assert_stats_moved_alike(module, variables, new_stats):
    """The port's running stats after a training forward equal JAX's new
    ``batch_stats``, and each moved."""
    want = _stats(state_dict_from_jax({**variables, **new_stats}, module))
    before = _stats(state_dict_from_jax(variables, module))
    got = _stats(module.state_dict())
    assert want and set(want) == set(got)
    for k in want:
        assert not np.allclose(want[k], before[k]), k
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k,
                                   **STATS_TOL)


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(7).integers(0, 256, (2, 8, 64, 64, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def tiny_by_mode(repo_root, clips):
    """{mode: the tiny SlowFast with ``SlowFastHead`` of 7 classes},
    built once per mode."""
    out = {}

    def get(mode):
        if mode not in out:
            out[mode] = tiny_model(
                repo_root, SF, TINY + head_opts("SlowFastHead", "7")
                + ["VIDEO.BACKBONE.SLOWFAST.MODE", mode], clips,
                MODES.index(mode) + 1)
        return out[mode]
    return get


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", MODES)
def test_tiny_slowfast_matches_jax(tiny_by_mode, clips, mode, train):
    cfg, _, jmodel, variables, model = tiny_by_mode(mode)
    load_jax(model.module, variables)     # running stats as calibrated
    (want, wfeat, new_stats), (got, feat) = run_both(
        cfg, jmodel, variables, model, clips, train)
    assert tuple(got.shape) == (2, 7)
    widths = {"slowfast": 256 + 32, "slowonly": 256, "fastonly": 32}
    assert tuple(feat.shape) == (2, widths[mode])
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(wfeat),
                               **FEAT_TOL)
    if train:
        assert_preds(got, want, TRAIN_TOL)
        assert_stats_moved_alike(model.module, variables,
                                 new_stats)
    else:
        assert_preds(got, want, TOL)
        assert float(np.asarray(want).max()) < 0.99     # not a one-hot
    has_fusion = any(k.startswith("backbone.fusion")
                     for k in model.module.state_dict())
    assert has_fusion == (mode == "slowfast")


@pytest.fixture(scope="module")
def tiny_x2(repo_root, clips):
    return tiny_model(repo_root, SF,
                      TINY + head_opts("SlowFastHeadx2", "[5, 11]"), clips, 9)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_tiny_slowfast_headx2_matches_jax(tiny_x2, clips, train):
    """``SlowFastHeadx2``: ``{"verb_class", "noun_class"}`` from the shared
    pooled feature; softmax rows at eval, logits in train mode."""
    cfg, _, jmodel, variables, model = tiny_x2
    load_jax(model.module, variables)
    (want, _, new_stats), (got, _) = run_both(cfg, jmodel, variables, model,
                                              clips, train)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "verb_class": (2, 5), "noun_class": (2, 11)}
    assert_preds(got, want, TRAIN_TOL if train else TOL)
    if train:
        assert_stats_moved_alike(model.module, variables, new_stats)
    else:
        np.testing.assert_allclose(got["noun_class"].sum(-1).numpy(), 1.0,
                                   rtol=1e-6)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fuse_fast_to_slow_matches_jax(repo_root, train):
    """The lateral conv (kernel 5, stride ``ALPHA`` 4, with bias), its
    BatchNorm (flax's momentum 0.99 in train mode) and ReLU, concatenated
    on the slow stream's channels; the fast stream passes through."""
    cfg, jcfg = cfgs(repo_root, SF, TINY + [
        "VIDEO.BACKBONE.SLOWFAST.FUSION_CONV_BIAS", "true"])
    rng = np.random.default_rng(11)
    x_slow = rng.standard_normal((2, 2, 4, 4, 16)).astype(np.float32)
    x_fast = rng.standard_normal((2, 8, 4, 4, 8)).astype(np.float32)
    jmod = js.FuseFastToSlow(jcfg, 8)
    variables = jax_variables(jmod, 12, jnp.asarray(x_slow),
                              jnp.asarray(x_fast), train=False)
    mod = load_jax(port_module(ps.FuseFastToSlow, cfg, 8), variables)
    assert mod.conv_f2s.bias is not None and mod.bn.momentum == \
        pytest.approx(0.01)
    set_bn_frozen(False)
    args = (jnp.asarray(x_slow), jnp.asarray(x_fast))
    if train:
        (want, _), new_stats = jmod.apply(variables, *args, train=True,
                                          mutable=["batch_stats"])
    else:
        want, _ = jmod.apply(variables, *args, train=False)
    mod.train(train)
    with torch.no_grad():
        got, fast = mod(to_ncdhw(x_slow), to_ncdhw(x_fast))
    assert tuple(got.shape) == (2, 16 + 16, 2, 4, 4)
    np.testing.assert_allclose(from_ncdhw(got), np.asarray(want), **TOL)
    assert torch.equal(fast, to_ncdhw(x_fast))
    if train:
        assert_stats_moved_alike(mod, variables, new_stats)


def test_temporal_conv_bottleneck_is_a_3x1x1_conv(repo_root):
    """The shipped config's fast stage 3: ``KERNEL_SIZE`` [1, 3, 3] with
    ``TEMPORAL_CONV_BOTTLENECK`` set, so ``a`` is ``(3, 1, 1)`` in both
    packages (and ``(1, 1, 1)`` where the flag is off); the branch equals
    JAX's in eval mode, and its outer temporal taps count: zeroing them
    breaks the tolerance."""
    cfg, jcfg = cfgs(repo_root, SF, ["VIDEO.BACKBONE.NUM_FILTERS",
                                     "[32, 32, 64, 128, 256]"])
    assert list(cfg.VIDEO.BACKBONE.KERNEL_SIZE[1][2]) == [1, 3, 3]
    spec = js._PathwayCfg(jcfg, 1).block_spec(2, 0)
    pspec = ps._PathwayCfg(cfg, 1).block_spec(2, 0)
    assert spec == {**pspec, "branch_cfg": spec["branch_cfg"]}
    assert spec["temporal_conv_bottleneck"] and spec["dim_in"] == 4
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 4, 8, 8, 4)).astype(np.float32)
    jmod = js.SlowfastBranch(spec)
    variables = jax_variables(jmod, 14, jnp.asarray(x), train=False)
    assert variables["params"]["a"]["conv"]["kernel"].shape[:3] == (3, 1, 1)
    mod = load_jax(port_module(ps.SlowfastBranch, pspec), variables).eval()
    assert tuple(mod.a.weight.shape[2:]) == (3, 1, 1)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = from_ncdhw(mod(to_ncdhw(x)))
        np.testing.assert_allclose(got, want, **TOL)
        mod.a.weight[:, :, [0, 2]] = 0.0
        control = from_ncdhw(mod(to_ncdhw(x)))
    assert not np.allclose(control, want, **TOL)
    slow = ps._PathwayCfg(cfg, 0)
    assert not slow.block_spec(2, 0)["temporal_conv_bottleneck"]
    assert tuple(port_module(ps.SlowfastBranch, slow.block_spec(2, 0))
                 .a.weight.shape[2:]) == (1, 1, 1)


def test_slowfast_ek100_full_width_maps_onto_jax_and_builds(repo_root):
    """SlowFast R50 8x8 with ``SlowFastHeadx2`` [97, 300] at full width
    (32 frames at 224^2): 34.56 M weights one to one with the JAX tree; it
    builds on the CPU in eval mode, its head over 2048 + 256 features,
    and every fusion's BatchNorm at flax's momentum."""
    module, n = assert_tree_maps_one_to_one(repo_root, SF, 32, 224)
    assert 34.5e6 < n < 34.6e6
    cfg, _ = cfgs(repo_root, SF)
    model = pm.build_model(cfg, device="cpu")
    head = model.module.head
    assert isinstance(head, ps.SlowFastHeadx2) and model.head is None
    assert (head.out1.in_features, head.out1.out_features,
            head.out2.out_features) == (2304, 97, 300)
    assert not model.module.training and not model.is_text_model
    fusions = [m for n, m in model.module.named_modules()
               if n.startswith("backbone.fusion")
               and isinstance(m, ps.FuseFastToSlow)]
    assert len(fusions) == 4
    assert all(m.bn.momentum == pytest.approx(0.01) for m in fusions)


def test_engine_serves_slowfast_with_its_head(repo_root, clips):
    """``InferenceEngine`` serves SlowFast with ``SlowFastHead``: a request
    of 2 clips gives the eval forward's softmax scores, at the smallest
    bucket that holds it."""
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg, _ = cfgs(repo_root, SF, TINY + head_opts("SlowFastHead", "7"))
    engine = InferenceEngine(cfg, batch_size=4, device="cpu")
    assert engine.buckets() == [1, 2, 4]
    scores = engine.predict(clips)
    with torch.no_grad():
        want, _ = engine.model.apply(
            {"video": _prep_video(cfg, torch.from_numpy(clips))})
    assert scores.shape == (2, 7)
    np.testing.assert_allclose(scores, want.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(scores.sum(-1), 1.0, rtol=1e-6)
