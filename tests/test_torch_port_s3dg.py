"""The port's S3D-G (``dist_tpu_torch/models/backbones/s3dg.py``) against
the JAX package's on the CPU, fp32, on seeded JAX weights brought across
by ``models/backbones/convert.py`` (``tests/test_torch_port_slowfast.py``'s
helpers):

- ``SelfGating``, ``STConv3d`` (stride 1 and 2) and one
  ``InceptionBlock3D`` (S3D-G, and I3D without gating), in eval and in
  train mode: outputs at ``atol=2e-4, rtol=1e-4``, the updated running
  stats (flax's momentum 0.99) at ``STATS_TOL``;
- ``Inception3D`` whole with ``BaseHead`` at 8 frames of 32^2, eval and
  train, running stats calibrated near the data's (``WHOLE_REL``);
- the zero-size assertion at 4 frames, with the JAX package's message;
- both HiCo fine-tune configs at full width: the state dict one to one
  with the JAX tree, and they build on the CPU."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.backbones import s3dg as jg
from dist_tpu.models.base.bn import set_bn_frozen
from dist_tpu_torch.models.backbones import s3dg as pg
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
from tests.test_torch_port_slowfast import (
    assert_stats_moved_alike,
    run_both,
    tiny_model,
)
from tests.test_torch_port_tada import _rel

HMDB = "configs/projects/hico/ft_s3dg_hmdb.yaml"
HICO_PP = "configs/projects/hico++/ft-hmdb51/ft_hico++_uk400_s3dg_32x224.yaml"
SMALL = ["DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32",
         "DATA.TEST_CROP_SIZE", "32", "VIDEO.HEAD.NUM_CLASSES", "7",
         "VIDEO.HEAD.DROPOUT_RATE", "0.0", "TRAIN.CHECKPOINT_FILE_PATH", "",
         "LOG_MODEL_INFO", "false"]
# the whole S3D-G in fp32, relative L2: 3 times the CPU's worst
# reading (8.9e-4, the train-mode features)
WHOLE_REL = 3e-3
# (name, JAX module, port module, NDHWC input shape)
MODULES = [
    ("SelfGating", lambda: jg.SelfGating(), lambda: pg.SelfGating(16),
     (2, 4, 6, 6, 16)),
    ("STConv3d", lambda: jg.STConv3d(12, 3, 1),
     lambda: pg.STConv3d(16, 12, 3, 1), (2, 4, 6, 6, 16)),
    ("STConv3d-stride2", lambda: jg.STConv3d(12, 3, 2),
     lambda: pg.STConv3d(16, 12, 3, 2), (2, 4, 6, 6, 16)),
    ("InceptionBlock3D", lambda: jg.InceptionBlock3D([8, 8, 12, 4, 8, 8]),
     lambda: pg.InceptionBlock3D(16, [8, 8, 12, 4, 8, 8]), (2, 4, 6, 6, 16)),
    ("InceptionBlock3D-i3d",
     lambda: jg.InceptionBlock3D([8, 8, 12, 4, 8, 8], False, False),
     lambda: pg.InceptionBlock3D(16, [8, 8, 12, 4, 8, 8], False, False),
     (2, 4, 6, 6, 16)),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("index", range(len(MODULES)),
                         ids=[m[0] for m in MODULES])
def test_s3dg_modules_match_jax(index, train):
    name, jmake, pmake, shape = MODULES[index]
    x = np.random.default_rng(20 + index).standard_normal(shape) \
        .astype(np.float32)
    jmod = jmake()
    gate_only = name == "SelfGating"
    kwargs = {} if gate_only else {"train": False}
    variables = jax_variables(jmod, 30 + index, jnp.asarray(x), **kwargs)
    with torch.device("meta"):
        mod = pmake()
    mod = load_jax(mod.to_empty(device="cpu"), variables).train(train)
    set_bn_frozen(False)
    new_stats = None
    if train and not gate_only:
        want, new_stats = jmod.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x),
                          **({} if gate_only else {"train": train}))
    with torch.no_grad():
        got = from_ncdhw(mod(to_ncdhw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if new_stats is not None:
        assert_stats_moved_alike(mod, variables, new_stats)
    if gate_only:
        # the gate is not the identity: each channel is scaled in (0, 1)
        ratio = np.asarray(want) / x
        assert 0.1 < float(ratio.min()) and float(ratio.max()) < 0.9


@pytest.fixture(scope="module")
def clips():
    return np.random.default_rng(40).integers(0, 256, (8, 8, 32, 32, 3),
                                              dtype=np.uint8)


@pytest.fixture(scope="module")
def tiny_s3dg(repo_root, clips):
    return tiny_model(repo_root, HMDB, SMALL, clips, 41)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_inception3d_with_base_head_matches_jax(tiny_s3dg, clips, train):
    """S3D-G at full width (its plan is fixed) on 8 clips of 8 frames of
    32^2, with ``BaseHead`` over its 1024 features: eval scores at
    ``atol=2e-4, rtol=1e-4``; the pooled features, and the train logits,
    within ``WHOLE_REL`` (relative L2); every running stat moved alike.
    The maps of ``Mixed_5b``/``5c`` are 1 x 1 x 1 here, so BatchNorm's
    statistics there are over the batch alone: at 2 clips the two fp32
    forwards drift apart by 0.19-0.49 (relative L2), at 8 by 3.9e-4 in
    eval and 8.9e-4 in train mode on the CPU."""
    cfg, _, jmodel, variables, model = tiny_s3dg
    load_jax(model.module, variables)
    (want, wfeat, new_stats), (got, feat) = run_both(
        cfg, jmodel, variables, model, clips, train)
    assert tuple(got.shape) == (8, 7) and tuple(feat.shape) == (8, 1024)
    assert _rel(feat.detach().numpy(), np.asarray(wfeat)) < WHOLE_REL
    if train:
        assert _rel(got.detach().numpy(), np.asarray(want)) < WHOLE_REL
        assert_stats_moved_alike(model.module, variables, new_stats)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert float(np.asarray(want).max()) < 0.99


def test_zero_size_assertion_at_4_frames(repo_root):
    """A 4-frame clip collapses T to 0 at the ``(2, 2, 2)`` pool: both
    packages stop with the same assertion and the same message, the shape
    in it NDHWC as the JAX package reports it."""
    cfg, jcfg = cfgs(repo_root, HMDB, SMALL)
    x = np.zeros((1, 4, 32, 32, 3), np.float32)
    jmod = jg.Inception3D(jcfg)
    with pytest.raises(AssertionError) as jax_error:
        jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0),
                                         jnp.asarray(x), train=False))
    mod = port_module(pg.Inception3D, cfg).eval()
    with pytest.raises(AssertionError) as port_error:
        with torch.no_grad():
            mod(torch.from_numpy(x))
    assert str(port_error.value) == str(jax_error.value)
    m = re.match(r"^S3D-G collapsed a dimension to zero \(\(([\d, ]+)\)\)",
                 str(port_error.value))
    assert tuple(int(v) for v in m.group(1).split(",")) == (1, 0, 1, 1, 1024)
    assert "needs >= 8 frames" in str(port_error.value)


@pytest.mark.parametrize("path,frames,crop,classes", [
    (HMDB, 16, 112, 51), (HICO_PP, 32, 224, 51)], ids=["16x112", "32x224"])
def test_hico_configs_map_onto_jax_and_build(repo_root, path, frames, crop,
                                             classes):
    """S3D-G with ``BaseHead`` at full width: 9.15 M weights one to one
    with the JAX tree; the config builds on the CPU (with
    ``TRAIN.CHECKPOINT_FILE_PATH ""``, the released checkpoint being
    absent), its head over 1024 features, every BatchNorm at flax's
    momentum, and it maps a clip of the config's geometry to scores."""
    opts = ["TRAIN.CHECKPOINT_FILE_PATH", ""]
    _, n = assert_tree_maps_one_to_one(repo_root, path, frames, crop, opts)
    assert 9.1e6 < n < 9.2e6
    cfg, _ = cfgs(repo_root, path, opts)
    assert (int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)) \
        == (frames, crop)
    model = pm.build_model(cfg, device="cpu")
    head = model.module.head
    assert isinstance(head, pm.BaseHead) and model.head is None
    assert (head.out.in_features, head.out.out_features) == (1024, classes)
    bns = [m for m in model.module.modules()
           if isinstance(m, torch.nn.BatchNorm3d)]
    assert len(bns) == 5 + 9 * 8 and all(
        m.momentum == pytest.approx(0.01) for m in bns)
    if frames == 16:
        clip = np.random.default_rng(0).integers(
            0, 256, (1, frames, crop, crop, 3), dtype=np.uint8)
        with torch.no_grad():
            scores, feat = model.apply(
                {"video": _prep_video(cfg, torch.from_numpy(clip))})
        assert tuple(scores.shape) == (1, classes)
        assert bool(torch.isfinite(scores).all())
        assert float(scores.sum()) == pytest.approx(1.0, abs=1e-5)


def test_engine_serves_s3dg_with_base_head(repo_root, clips):
    """``InferenceEngine`` serves S3D-G with ``BaseHead`` (random weights:
    ``TRAIN.CHECKPOINT_FILE_PATH ""``): a request of 3 clips gives the eval
    forward's softmax scores, padded to the bucket of 4."""
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg, _ = cfgs(repo_root, HMDB, SMALL)
    engine = InferenceEngine(cfg, batch_size=4, device="cpu")
    scores = engine.predict(clips[:3])
    with torch.no_grad():
        want, _ = engine.model.apply(
            {"video": _prep_video(cfg, torch.from_numpy(clips[:3]))})
    assert scores.shape == (3, 7)
    np.testing.assert_allclose(scores, want.numpy(), atol=1e-6, rtol=0)
