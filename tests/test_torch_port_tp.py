"""The tensor-parallel ``model`` axis (``parallel/tensor.py``) at tp 2 on
the CPU: two gloo ranks spawned once for the file through the port's
launcher (one data shard of two model ranks), on a tiny CLIP+DiST whose
towers and pooling are 128 wide with two heads of 64 (the model axis
splits heads), in fp32 with EMA on, one global batch of 8.

- The eval forward against the replicated model; a control that splits
  ``in_proj`` contiguously (rank 0 all of Q and half of K) must break it.
- Two train steps against the one-process run, and the first against the
  JAX package's step on its 8-device mesh of data 4 x model 2 (its
  Megatron placement, ``shard_params``); the checkpoint holds the full
  tensors of the replicated run's file."""

import os
import re

import numpy as np
import pytest
import torch

import dist_tpu.models.clip.model as jax_clip_model
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as R
from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict
from tests.test_torch_port_ddp import GLOBAL_BATCH, OPTS, TINY, _jax_step

SPAWN_TIMEOUT_S = 600
STEPS = 2
WIDE_OPTS = OPTS + ["VIDEO.BACKBONE.META_ARCH_NAME", R.WIDE,
                    "VIDEO.BACKBONE.DIST.INTEGRATION_DIM", "128",
                    "VIDEO.BACKBONE.DIST.TEMPORAL_DIM", "16"]
TP = ["TPU.MESH.MODEL", "2"]
# JAX's mesh: 8 devices of data 4 x model 2, per-shard batch 2
JAX_TP = TP + ["TRAIN.BATCH_SIZE", "2"]
ARCH = dict(embed_dim=32, image_resolution=64, vision_layers=2,
            vision_width=128, vision_patch_size=16, context_length=77,
            vocab_size=49408, transformer_width=128, transformer_layers=2)
# the weights JAX's rule splits (its path suffixes)
SPLIT = (r"\.attn\.(in_proj_weight|in_proj_bias|out_proj\.weight)$"
         r"|\.(mlp|ffn)\.(c_fc\.weight|c_fc\.bias|c_proj\.weight)$")
# fp32 in another summation order (the all-reduce of two partial sums)
SCORE_ATOL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-5


def _inputs(repo_root):
    """The JAX config and params of the wide tiny model and one seeded
    global batch."""
    path = os.path.join(repo_root, TINY)
    jcfg = jax_load_config(path, WIDE_OPTS + JAX_TP, make_output_dir=False)
    rng = np.random.default_rng(0)
    sd = make_clip_state_dict(rng, **ARCH)
    jdist = JaxDiSTConfig.from_cfg(jcfg)
    add_dist_state_dict(sd, rng, jdist, d_model=ARCH["vision_width"])
    params, _ = convert_clip_params(sd, with_dist=jdist)
    n, crop = int(jcfg.DATA.NUM_INPUT_FRAMES), int(jcfg.DATA.TRAIN_CROP_SIZE)
    classes = int(jcfg.VIDEO.HEAD.NUM_CLASSES)
    rng = np.random.default_rng(7)
    batch = {"video": rng.integers(0, 256, (GLOBAL_BATCH, n, crop, crop, 3),
                                   dtype=np.uint8),
             "labels": rng.integers(0, classes, GLOBAL_BATCH).astype(np.int32),
             "text_features": rng.standard_normal(
                 (classes, ARCH["embed_dim"])).astype(np.float32)}
    return jcfg, params, batch


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads in this process while the file's fixture runs
    (the spawned ranks share them: one each): the suite runs in several
    worker processes at once, and every core in each of them would
    oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(repo_root, tmp_path_factory, few_threads):
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clip_model.ARCHITECTURES, R.WIDE,
                   jax_clip_model.CLIPArchitecture(32, 64, 2, 128, 16, 77,
                                                   49408, 128, 2, 2))
        jcfg, params, batch = _inputs(repo_root)
        jax = _jax_step(jcfg, params, batch)
    weights = {k: np.asarray(v, np.float32)
               for k, v in state_dict_from_jax(params).items()}
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, WIDE_OPTS + TP, make_output_dir=False)
    plain = load_config(path, WIDE_OPTS, make_output_dir=False)
    out = str(tmp_path_factory.mktemp("tp"))
    R.register_wide()
    one = {"eval": R.eval_scores(plain, weights, batch),
           "steps": R.train_steps(plain, weights, batch, STEPS,
                                  os.path.join(out, "one"))}
    group = launch.launch_task(cfg, R.group_runs, ([
        ("eval_scores", (cfg, weights, batch)),
        ("eval_scores", (cfg, weights, batch, True)),
        ("train_steps", (cfg, weights, batch, STEPS,
                         os.path.join(out, "tp")))],), device="cpu",
        timeout=SPAWN_TIMEOUT_S)
    return {"one": one, "group": group, "jax": jax, "jcfg": jcfg}


def _flip(jcfg, lr):
    b1, b2 = jcfg.OPTIMIZER.BETAS
    travel = lr * float(jcfg.OPTIMIZER.NEW_NET_LRMULT)
    return travel, 2 * (1 - b1) / np.sqrt(1 - b2) * travel


def test_tp_forward_matches_replicated_and_naive_split_breaks(runs):
    """Both model ranks give the replicated model's scores; the contiguous
    split of the fused projection does not."""
    want = runs["one"]["eval"]
    for got, naive, _ in runs["group"]:
        np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
        assert np.abs(naive - want).max() > 100 * SCORE_ATOL


def test_tp_steps_match_one_process(runs):
    """Each step's loss, the first step's gradients (every trainable
    leaf, full), the weights after the steps within AdamW's flip bound;
    both ranks alike."""
    one = runs["one"]["steps"]
    r0, r1 = (g[2] for g in runs["group"])
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=LOSS_REL)
    assert r0["losses"] == r1["losses"]
    for k, g in one["grads"].items():
        np.testing.assert_allclose(r0["grads"][k], g, rtol=0, err_msg=k,
                                   atol=GRAD_REL * float(np.abs(g).max())
                                   + 1e-12)
    _, flip = _flip(runs["jcfg"], runs["jax"][3])
    for k, w in one["weights"].items():
        np.testing.assert_array_equal(r0["weights"][k], r1["weights"][k], k)
        assert np.abs(r0["weights"][k] - w).max() <= STEPS * flip, k


def test_tp_step_matches_jax_model_axis(runs):
    """The first step against JAX's on data 4 x model 2: the loss, every
    trainable gradient and the weights after it."""
    loss, grads, after, lr = runs["jax"]
    got = runs["group"][0][2]
    assert got["losses"][0] == pytest.approx(loss, rel=LOSS_REL)
    travel, flip = _flip(runs["jcfg"], lr)
    assert got["grads"]
    for name, g in got["grads"].items():
        want = grads[name]
        np.testing.assert_allclose(
            g, want, rtol=0, err_msg=name,
            atol=GRAD_REL * float(np.abs(want).max()) + 1e-12)
        steady = np.abs(want) >= 1e-3 * np.abs(want).max()
        err = np.abs(got["first_weights"][name] - after[name])
        assert (err[steady] <= 1e-6 + 0.01 * travel).all(), name
        assert (err <= flip).all(), name


def test_tp_splits_heads_and_writes_the_replicated_file(runs):
    """A rank holds half of each weight the rule splits (every block's
    fused projection, out_proj and MLP here: two heads each) and the rest
    whole; the checkpoint holds the full tensors under the replicated
    run's keys, shapes and optimizer ids."""
    r0 = runs["group"][0][2]
    one = runs["one"]["steps"]
    split = sum(v.size for k, v in one["weights"].items()
                if re.search(SPLIT, k))
    assert split > 0
    assert r0["total_params"] == one["total_params"]
    assert one["total_params"] - r0["local_params"] == split // 2
    tp = torch.load(r0["checkpoint"], weights_only=True)
    ref = torch.load(one["checkpoint"], weights_only=True)
    for key in ("model_state", "ema"):
        assert {k: v.shape for k, v in tp[key].items()} == {
            k: v.shape for k, v in ref[key].items()}
        for k, v in tp[key].items():
            np.testing.assert_array_equal(v.numpy(), r0["weights"][k]
                                          if key == "model_state"
                                          else v.numpy(), k)
    assert sorted(tp["optimizer_state"]["state"]) == sorted(
        ref["optimizer_state"]["state"])
    for i, entry in tp["optimizer_state"]["state"].items():
        for k, v in entry.items():
            assert v.shape == ref["optimizer_state"]["state"][i][k].shape
