"""The HiCo++ ViT-S fine-tune on the port, tiny, against the JAX package
on the CPU:

- one train step of ``configs/projects/hico++/ft_vit-s_hmdb.yaml`` cut to
  width 64, 2 heads, depth 2, 4 frames of 32^2 (patch 8), ``DROP_PATH 0``
  and ``AUTOAUGMENT`` off, with the config's AdamW (weight decay 0.05,
  the cosine LR's first warm-up step), both packages in float64 (the JAX
  one under ``jax.enable_x64``): the loss (``LOSS_RTOL``), each gradient
  leaf (``GRAD_TOL`` of its largest entry; the JAX step's read off an
  optimizer that keeps them) and each updated weight (``UPDATE_TOL`` of
  the step's LR, plus the LR times the two gradients' difference over
  Adam's eps);
- the ``lft`` linear probe (``TRAIN.ONLY_LINEAR``): one step leaves every
  backbone weight bit for bit and moves the head;
- each parameter's optimizer group against the JAX package's label of
  its counterpart, for the ViT-S fine-tune, TimeSformer, ViViT (with
  ``TransformerHead``), the factorized encoder and both TAda-ConvNeXt
  variants, with the rules' landmarks pinned (every LayerNorm named
  ``norm...`` in the BN group; ``pos_embd``, ``temp_embd`` and
  ``cls_token`` without decay; ``cls_token_out``, ``gamma`` and
  ``dwconv_bias`` decayed, as JAX does);
- ``build_backbone_on_meta`` on the twelve configs at full width: every
  entry maps onto the JAX tree at its shape, and the weight counts;
- the tiny ViT-S run list through ``python -m dist_tpu_torch.run
  --device cpu``: train, val, the test and the 10-view test at 48^2
  (the position table grown)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.base import models as jm
from dist_tpu.optim import optimizer as jopt
from dist_tpu.tasks import state as jstate
from dist_tpu_torch import run
from dist_tpu_torch.models.backbones.convert import jax_table, state_dict_from_jax
from dist_tpu_torch.models.base import models as pm
from dist_tpu_torch.optim import optimizer
from dist_tpu_torch.optim.optimizer import construct_optimizer
from dist_tpu_torch.tasks import state as pstate
from dist_tpu_torch.tasks.state import _prep_video
from tests.test_torch_port_epic_step import _keep_grads
from tests.test_torch_port_optim import _jax_leaf, _port_probe
from tests.test_torch_port_resnet3d import cfgs, load_jax
from tests.test_torch_port_video_transformer import (
    concrete_linspace,
    variables_of,
)

FT = "configs/projects/hico++/ft_vit-s_hmdb.yaml"
LFT = "configs/projects/hico++/ft-hmdb51/lft_hico++_uk400_vit-s_16x112.yaml"
TINY = ["VIDEO.BACKBONE.NUM_FEATURES", "64", "VIDEO.BACKBONE.NUM_HEADS", "2",
        "VIDEO.BACKBONE.DEPTH", "2", "VIDEO.BACKBONE.PATCH_SIZE", "8",
        "VIDEO.BACKBONE.DROP_PATH", "0.0", "DATA.NUM_INPUT_FRAMES", "4",
        "DATA.TRAIN_CROP_SIZE", "32", "VIDEO.HEAD.NUM_CLASSES", "5",
        "AUGMENTATION.AUTOAUGMENT.ENABLE", "false",
        "TRAIN.CHECKPOINT_FILE_PATH", ""]
# float64 readings on the CPU: the loss 1.8e-8 apart (the JAX package
# takes it in fp32), the worst gradient leaf 3.2e-7 of its largest entry
# (JAX rounds the attention's scores to fp32 even in float64:
# preferred_element_type); the limits about 10 times these. The updated
# weights within lr * (UPDATE_TOL + |g - g_jax| / ADAM_EPS): Adam's first
# step moves a weight by lr * g / (|g| + eps), which changes by at most
# the gradients' difference over eps. The keys' bias, whose gradient is
# rounding (softmax ignores it), reads 0.998 of that bound, every other
# weight at most 0.004 of it
LOSS_RTOL = 2e-7
GRAD_TOL = 3e-6
UPDATE_TOL = 1e-6
ADAM_EPS = 1e-8


@pytest.fixture(scope="module")
def tiny(repo_root):
    cfg, jcfg = cfgs(repo_root, FT, TINY)
    jmodel = jm.build_model(jcfg)
    variables = variables_of(lambda key: jmodel.init(
        key, {"video": jnp.zeros((1, 4, 32, 32, 3))}), 60)
    rng = np.random.default_rng(61)
    clips = rng.integers(0, 256, (2, 4, 32, 32, 3), dtype=np.uint8)
    labels = np.array([1, 4], np.int32)
    return cfg, jcfg, jmodel, variables, clips, labels


def jax_shapes(jmodel, frames, crop=32):
    """The JAX model's variables' shapes after an init on ``(1, frames,
    crop, crop, 3)``, traced on an abstract clip."""
    with concrete_linspace():
        return jax.eval_shape(
            lambda key, x: jmodel.init(key, {"video": x}),
            jax.random.PRNGKey(0),
            jax.ShapeDtypeStruct((1, frames, crop, crop, 3), jnp.float32))


def _jax_step(jmodel, jcfg, tx, lr_fn, variables, batch):
    """The JAX train step in float64."""
    with jax.enable_x64(True), concrete_linspace():
        step = jax.jit(jstate.make_train_step(jmodel, jcfg, tx, lr_fn))
        wide = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a, np.float64)), variables)
        new, metrics = step(jstate.create_train_state(wide, tx),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))
        return jax.device_get((new, metrics))


def test_vit_s_step_matches_jax_leaf_by_leaf(tiny):
    cfg, jcfg, jmodel, variables, clips, labels = tiny
    video = _prep_video(cfg, torch.from_numpy(clips)).double().numpy()
    batch = {"video": video, "labels": labels}
    tx, jlr = jopt.construct_optimizer(jcfg, variables, 4)
    jnew, want = _jax_step(jmodel, jcfg, tx, jlr, variables, batch)
    jgrads_state, _ = _jax_step(jmodel, jcfg, _keep_grads(), jlr, variables,
                                batch)

    model = pm.build_model(cfg, device="cpu")
    load_jax(model.module, variables)
    model.module.double()
    opt, lr_fn = construct_optimizer(cfg, model.module, 4)
    assert type(opt) is torch.optim.AdamW
    grads = {}
    opt.register_step_pre_hook(lambda *_: grads.update(
        {k: p.grad.detach().clone()
         for k, p in model.module.named_parameters()}))
    got = pstate.make_train_step(model, cfg, opt, lr_fn)(
        pstate.create_train_state(model, opt),
        {"video": torch.from_numpy(video),
         "labels": torch.from_numpy(labels).long()})
    lr = lr_fn(0)
    assert lr == pytest.approx(float(jlr(0)), rel=1e-6) == 2e-5
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=LOSS_RTOL)
    jgrads = state_dict_from_jax(jgrads_state.opt_state, model.module)
    before = state_dict_from_jax(variables, model.module)
    after = state_dict_from_jax(jnew.variables, model.module)
    assert len(grads) == len(jgrads) == 32
    for k, p in model.module.named_parameters():
        g, w = grads[k].numpy(), jgrads[k]
        assert g.dtype == w.dtype == np.float64, k
        scale = float(np.abs(w).max())
        assert scale > 0, k
        np.testing.assert_allclose(g, w, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=k)
        bound = lr * (UPDATE_TOL + np.abs(g - w) / ADAM_EPS)
        diff = np.abs(p.detach().numpy() - after[k])
        assert (diff <= bound).all(), (k, float((diff / bound).max()))


def test_linear_probe_leaves_the_backbone_bit_for_bit(repo_root, tiny):
    """``lft``: only ``head.*`` trains (the JAX labels freeze the rest too,
    ``test_param_groups_match_jax``); one step moves the head and leaves
    every backbone weight bit for bit."""
    cfg, _ = cfgs(repo_root, LFT, TINY)
    assert cfg.TRAIN.ONLY_LINEAR
    _, _, _, variables, clips, labels = tiny
    model = pm.build_model(cfg, device="cpu")
    load_jax(model.module, variables)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    opt, lr_fn = construct_optimizer(cfg, model.module, 4)
    pstate.make_train_step(model, cfg, opt, lr_fn)(
        pstate.create_train_state(model, opt),
        {"video": torch.from_numpy(clips),
         "labels": torch.from_numpy(labels).long()})
    for k, v in model.module.state_dict().items():
        moved = not torch.equal(v, before[k])
        assert moved == k.startswith("head."), k


GROUP_CASES = {
    "vit-s-ft": (FT, TINY),
    "vit-s-lft": (LFT, TINY),
    "timesformer": ("configs/pool/backbone/timesformer.yaml", TINY),
    "vivit": ("configs/pool/backbone/vivit.yaml", TINY),
    "vivit_fac_enc": ("configs/pool/backbone/vivit_fac_enc.yaml",
                      TINY + ["VIDEO.BACKBONE.DEPTH_TEMP", "1"]),
    "convnext": ("configs/pool/backbone/tada_convnext_tiny.yaml",
                 ["VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64]",
                  "VIDEO.BACKBONE.DEPTH", "[1, 1, 2, 1]",
                  "DATA.NUM_INPUT_FRAMES", "4", "VIDEO.HEAD.NUM_CLASSES",
                  "5"]),
    "convnext_original": (
        "configs/pool/backbone/tada_convnext_tiny_original.yaml",
        ["VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64]",
         "VIDEO.BACKBONE.DEPTH", "[1, 1, 2, 1]", "DATA.NUM_INPUT_FRAMES", "4",
         "VIDEO.HEAD.NUM_CLASSES", "5"]),
}
_POOL_OPTIM = ["OPTIMIZER.OPTIM_METHOD", "adamw", "OPTIMIZER.BASE_LR", "1000",
               "OPTIMIZER.WARMUP_EPOCHS", "0", "OPTIMIZER.WEIGHT_DECAY",
               "0.05"]


def _groups_match_jax(repo_root, path, opts):
    """Every parameter's group equals the JAX label of its counterpart
    (``models/backbones/convert.py::jax_table``), and one step of each
    optimizer moves it alike: from 0 with gradient 1 (the group's LR
    multiplier) and from 1 with gradient 0 (its weight decay), within
    ``rtol=1e-5``, as ``tests/test_torch_port_optim.py`` holds the conv
    family. Returns the port's labels."""
    cfg, jcfg = cfgs(repo_root, path, opts)
    shapes = jax_shapes(jm.build_model(jcfg), 4)
    zeros, ones = (jax.tree_util.tree_map(
        lambda s: np.full(s.shape, v, np.float32), shapes) for v in (0, 1))
    labels = jopt.param_labels(jcfg, zeros)
    tx, _ = jopt.construct_optimizer(jcfg, zeros, 4)
    update = jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])
    per_grad, per_decay = update(ones, zeros), update(zeros, ones)
    module = pm.build_model(cfg, device="cpu").module
    table = jax_table(module)
    got = optimizer.param_labels(cfg, module)
    got_grad = _port_probe(cfg, module, 0.0, 1.0)
    got_decay = _port_probe(cfg, module, 1.0, 0.0)
    for k in got:
        assert got[k] == _jax_leaf(labels, table[k]), k
        for probe, want in ((got_grad, per_grad), (got_decay, per_decay)):
            (g,), (w,) = (np.unique(probe[k]),
                          np.unique(_jax_leaf(want, table[k])))
            assert g == pytest.approx(float(w), rel=1e-5), k
    return got


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_param_groups_match_jax(repo_root, case):
    path, opts = GROUP_CASES[case]
    opts = opts + (["OPTIMIZER.BASE_LR", "1000", "OPTIMIZER.WARMUP_EPOCHS",
                    "0"] if "vit-s" in case else _POOL_OPTIM)
    got = _groups_match_jax(repo_root, path, opts)
    bb = {k[len("backbone."):]: v for k, v in got.items()
          if k.startswith("backbone.")}
    if case == "vit-s-lft":
        assert set(bb.values()) == {optimizer.FROZEN}
        assert got["head.out.weight"] == optimizer.TRAINABLE
        assert got["head.out.bias"] == optimizer.NO_WD
        return
    if "convnext" in case:
        want = {"stem_norm.weight": optimizer.BN,
                "down_norm1.bias": optimizer.BN,
                "stage0_block0.norm.weight": optimizer.BN,
                "stage0_block0.dwconv_rf.bn.weight": optimizer.BN,
                "stage0_block0.gamma": optimizer.TRAINABLE,
                "stage0_block0.dwconv_bias": optimizer.TRAINABLE,
                "stage0_block0.dwconv.weight": optimizer.TRAINABLE,
                "stem_conv.bias": optimizer.TRAINABLE}
        if case == "convnext_original":
            want["stage0_block0.avgpool_norm.weight"] = optimizer.BN
    else:
        want = {"cls_token": optimizer.NO_WD, "pos_embd": optimizer.NO_WD,
                "layer_0.norm.weight": optimizer.BN,
                "layer_0.norm_ffn.bias": optimizer.BN,
                "layer_0.attn.to_qkv.weight": optimizer.TRAINABLE,
                "stem.conv1.bias": optimizer.TRAINABLE}
        if case == "timesformer":
            want["layer_0.norm_temporal.weight"] = optimizer.BN
        if case == "vivit_fac_enc":
            want.update({"temp_embd": optimizer.NO_WD,
                         "cls_token_out": optimizer.TRAINABLE,
                         "norm_out.weight": optimizer.BN})
    for k, v in want.items():
        assert bb[k] == v, k


# (config, weights): the six HiCo++ ViT-S fine-tunes (51 or 101 classes)
# and the pool backbones at full width, the pool files over
# configs/pool/base.yaml (16 frames, a train crop of 112) with 400 classes
META = [
    ("configs/projects/hico++/ft_vit-s_hmdb.yaml", 21_911_091),
    ("configs/projects/hico++/ft_vit-s_ucf101.yaml", 21_930_341),
    ("configs/projects/hico++/ft-hmdb51/ft_hico++_uk400_vit-s_16x112.yaml",
     21_911_091),
    ("configs/projects/hico++/ft-hmdb51/lft_hico++_uk400_vit-s_16x112.yaml",
     21_911_091),
    ("configs/projects/hico++/ft-ucf101/ft_hico++_uk400_vit-s_16x112.yaml",
     21_930_341),
    ("configs/projects/hico++/ft-ucf101/lft_hico++_uk400_vit-s_16x112.yaml",
     21_930_341),
    ("configs/pool/backbone/timesformer.yaml", 114_924_688),
    ("configs/pool/backbone/vivit.yaml", 86_846_608),
    ("configs/pool/backbone/vivit_fac_enc.yaml", 114_943_888),
    ("configs/pool/backbone/vit-s.yaml", 22_045_456),
    ("configs/pool/backbone/tada_convnext_tiny.yaml", 38_661_688),
    ("configs/pool/backbone/tada_convnext_tiny_original.yaml", 38_674_936),
]


@pytest.mark.parametrize("path,weights", META, ids=[
    os.path.basename(m[0])[:-5] + ("-ucf" if "ucf" in m[0] else "")
    for m in META])
def test_configs_build_on_meta_and_map_onto_jax(repo_root, path, weights):
    """At full width on the meta device: a ``BaseVideoModel`` whose every
    state-dict entry has its JAX leaf at the shape the layout implies,
    every JAX leaf one entry, and the weight count (the JAX tree's, from
    an init on 16 frames; the crop does not change a shape)."""
    opts = ["TRAIN.CHECKPOINT_FILE_PATH", ""]
    if path.startswith("configs/pool"):
        opts += ["VIDEO.HEAD.NUM_CLASSES", "400"]
    cfg, jcfg = cfgs(repo_root, path, opts)
    module = pm.build_backbone_on_meta(cfg)
    assert isinstance(module, pm.BaseVideoModel)
    shapes = jax_shapes(jm.build_model(jcfg), 16)
    flat = {}
    for coll, tree in shapes.items():
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat[(coll, "/".join(str(q.key) for q in p))] = leaf.shape
    sd = module.state_dict()
    table = jax_table(module)
    assert set(table) == set(sd)
    seen = set()
    for key, leaf in table.items():
        if leaf is None:
            assert key.endswith("num_batches_tracked")
            continue
        shape = flat[(leaf.collection, leaf.path)]
        if leaf.layout == "conv":
            shape = tuple(shape[i] for i in (4, 3, 0, 1, 2))
        elif leaf.layout == "dense":
            shape = shape[::-1]
        assert tuple(sd[key].shape) == tuple(shape), key
        seen.add((leaf.collection, leaf.path))
    assert seen == set(flat)
    n = sum(p.numel() for p in module.parameters())
    assert n == sum(int(np.prod(s)) for (c, _), s in flat.items()
                    if c in ("params", "head"))
    assert n == weights


RUN_OPTS = TINY + [
    "DATA.SYNTHETIC", "true", "DATA.TEST_SCALE", "48",
    "DATA.TEST_CROP_SIZE", "48", "TRAIN.BATCH_SIZE", "2",
    "TEST.BATCH_SIZE", "2", "TRAIN.NUM_SAMPLES_LIMIT", "4",
    "TEST.NUM_SAMPLES_LIMIT", "2", "OPTIMIZER.MAX_EPOCH", "2",
    "TRAIN.NUM_FOLDS", "1", "OPTIMIZER.WARMUP_EPOCHS", "1",
    "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "1",
    "DATA_LOADER.NUM_WORKERS", "0", "LOG_MODEL_INFO", "false",
    "LOG_CONFIG_INFO", "false"]


def test_tiny_vit_s_run_list(repo_root, tmp_path):
    """train (2 epochs of 2 steps, a val eval and a checkpoint after
    each) -> test -> the automatic 10-view test, both at 48^2 where the
    model trained at 32^2: every view counted once, finite scores."""
    state, single, multi = run.main(
        ["--cfg", os.path.join(repo_root, FT), "--device", "cpu", *RUN_OPTS,
         "OUTPUT_DIR", str(tmp_path)])
    assert state.step == 4
    names = sorted(os.listdir(tmp_path / "checkpoints"))
    assert [n for n in names if n.endswith(".pyth")] == [
        "checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]
    for meter, views in ((single, 1), (multi, 10)):
        assert meter.num_clips == views
        assert (meter.clip_count == views).all() and meter.seen.all()
        assert np.isfinite(meter.video_preds).all()
