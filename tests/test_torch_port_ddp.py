"""Data-parallel training of the port at world 2 on the CPU: two gloo
ranks spawned through the port's own launcher (``parallel/launch.py``, a
``file://`` store), on ``tiny_synth.yaml`` in fp32, mixup and cutmix
off, EMA on (decay 0.9).

- The DDP train step against the JAX package's data-parallel step on its
  8-device virtual mesh (per-shard batch 1, global 8), rank r given rows
  [4r, 4r + 4) of the same global batch; with ``TPU.REMAT`` equal to
  without.
- The two faults of the port against the JAX package, repaired: the
  fused TemporalNet's refusal of more than one GPU and the loader
  signature's process count.
- The mixup pairing kept on purpose: each rank flips its own batch.

- A tiny TAda2D step at world 2 against one process at the global
  batch: BatchNorm over the global batch.

The run lists at world 2 are ``test_torch_port_ddp_run.py``'s."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import mixup as jmix
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.models.clip.clip_video import clip_dist_from_cfg as jax_clip
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu.optim import losses as jlosses
from dist_tpu.optim import optimizer as jopt
from dist_tpu.parallel.mesh import build_mesh, shard_batch, shard_params
from dist_tpu.tasks import state as jstate
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import mixup
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.clip_video import clip_dist_from_cfg
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu_torch.parallel import launch
from dist_tpu_torch.tasks.state import step_generator
from dist_tpu_torch.utils import checkpoint as cu
from tests import torch_ddp_ranks
from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict
from tests.test_torch_port_mixup import _case

TINY = "configs/projects/dist/test/tiny_synth.yaml"
TADA = "configs/projects/tada/k400/tada2d_8x8.yaml"
TADA_OPTS = ["VIDEO.BACKBONE.DEPTH", "18",
             "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
             "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
             "VIDEO.HEAD.NUM_CLASSES", "7", "VIDEO.HEAD.DROPOUT_RATE", "0.0",
             "TRAIN.BATCH_SIZE", "2", "TPU.MESH.DATA", "2",
             "OPTIMIZER.WARMUP_EPOCHS", "0", "OPTIMIZER.BASE_LR", "0.01"]
# a spawned group's time limit: a hung rendezvous fails the tests (the
# world-2 runs take ~10-20 s alone on this host, several times that
# beside the suite's other workers)
SPAWN_TIMEOUT_S = 600
OPTS = ["TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE", "false",
        "AUGMENTATION.CUTMIX.ENABLE", "false", "MODEL.EMA.ENABLE", "true",
        "MODEL.EMA.DECAY", "0.9", "LOG_CONFIG_INFO", "false",
        "LOG_MODEL_INFO", "false"]
# the step against JAX: the geometry of test_torch_port_train.py
STEP = OPTS + ["VIDEO.BACKBONE.DIST.TEMPORAL_DIM", "16"]
ARCH = dict(embed_dim=32, image_resolution=64, vision_layers=2,
            vision_width=64, vision_patch_size=16, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_layers=2)
GLOBAL_BATCH = 8


def _step_inputs(repo_root):
    """The tiny config for the step, the JAX params from tests/synth_ckpt
    and one seeded global batch."""
    path = os.path.join(repo_root, TINY)
    jcfg = jax_load_config(path, STEP, make_output_dir=False)
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


def _tada_inputs(repo_root):
    """A tiny TAda2D (fp32, dropout 0) with seeded weights, the zero
    inits and running stats drawn away from their init, and one seeded
    global batch of 4 clips of 4 x 64^2: conv5 keeps 2 x 2 positions a
    frame (at 32^2, one position: its BatchNorms' backward amplifies
    the two sums' rounding to 1.7e-5 in the stem's gradient)."""
    cfg = load_config(os.path.join(repo_root, TADA), TADA_OPTS,
                      make_output_dir=False)
    model = build_model(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(9)
    weights = {}
    for k, v in model.module.state_dict().items():
        v = v.numpy()
        if k.endswith("running_mean") or k.endswith("b_rf.b.weight"):
            v = rng.normal(0.0, 0.1, v.shape)
        elif k.endswith("running_var") or k.endswith("_bn.weight"):
            v = rng.uniform(0.5, 1.5, v.shape)
        weights[k] = np.asarray(v, v.dtype if k.endswith("tracked")
                                else np.float32)
    batch = {"video": rng.integers(0, 256, (4, 4, 64, 64, 3), dtype=np.uint8),
             "labels": rng.integers(0, 7, 4).astype(np.int32)}
    return cfg, weights, batch


@pytest.fixture(scope="module")
def world2(repo_root):
    """The DDP step at world 2, in one spawned group, without and with
    ``TPU.REMAT``, and the tiny TAda2D's step."""
    _, params, batch = _step_inputs(repo_root)
    cfgs = [load_config(os.path.join(repo_root, TINY),
                        STEP + ["TPU.MESH.DATA", "2", *opts],
                        make_output_dir=False)
            for opts in ([], ["TPU.REMAT", "true"])]
    weights = {k: np.asarray(v, np.float32)
               for k, v in state_dict_from_jax(params).items()}
    tada = _tada_inputs(repo_root)
    steps = launch.launch_task(
        cfgs[0], torch_ddp_ranks.ddp_steps,
        ([(cfg, weights, batch) for cfg in cfgs] + [tada],), device="cpu",
        timeout=SPAWN_TIMEOUT_S)
    return {"step": [s[0] for s in steps], "remat": [s[1] for s in steps],
            "tada": [s[2] for s in steps], "tada_inputs": tada,
            "weights": weights}


def _jax_step(jcfg, params, batch, fsdp=False):
    """The JAX package's jitted train step on its 8-device mesh at
    per-shard batch 1 (or the config's mesh and batch), with the gradient
    of the global batch's loss taken in the same jit: the loss, the
    gradients, the weights after AdamW and the LR of the step. ``fsdp``:
    the state placed as ``TPU.FSDP`` places it."""
    model = jax_build_model(jcfg)
    variables = {"params": params}
    tx, lr_fn = jopt.construct_optimizer(jcfg, variables, 4)
    state = jstate.create_train_state(variables, tx,
                                      float(jcfg.MODEL.EMA.DECAY))
    mesh = build_mesh(jcfg)
    assert mesh.shape["data"] == GLOBAL_BATCH // int(jcfg.TRAIN.BATCH_SIZE)
    train_step = jstate.make_train_step(model, jcfg, tx, lr_fn, mesh=mesh)

    def loss(v, b):
        inputs = {"video": jstate._prep_video(jcfg, b["video"]),
                  "text_features": b["text_features"]}
        preds, logits = model.apply(v, inputs, train=True)
        return jlosses.calculate_loss(
            jcfg, preds, logits, {"supervised": b["labels"]})[0]

    def step(state, b, rng):
        return jax.grad(loss)(state.variables, b), train_step(state, b, rng)

    with mesh:
        state = shard_params(mesh, state, fsdp=fsdp)
        sharded = shard_batch(mesh, {"video": batch["video"],
                                     "labels": batch["labels"]})
        sharded["text_features"] = jnp.asarray(batch["text_features"])
        grads, (state, metrics) = jax.jit(step)(state, sharded,
                                                jax.random.PRNGKey(0))
    grads = state_dict_from_jax(jax.device_get(grads)["params"])
    after = state_dict_from_jax(jax.device_get(state.variables)["params"])
    return float(metrics["loss"]), grads, after, float(lr_fn(0))


def test_ddp_step_matches_jax_data_parallel(repo_root, world2):
    """The loss (rel 1e-5), each dist_net gradient (atol 1e-5 of its
    largest value, ``test_torch_port_train.py``'s tolerance: fp32,
    another summation order), the weights after AdamW within its travel
    tolerance (an element whose gradient is within float noise of zero may
    step +-lr * mult), and both ranks' weights equal bit for bit."""
    jcfg, params, batch = _step_inputs(repo_root)
    loss, grads, after, lr = _jax_step(jcfg, params, batch)
    got = world2["step"]
    assert got[0]["losses"][0] == pytest.approx(loss, rel=1e-5)
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["grads"] and all(k.startswith("dist_net.")
                                   for k in got[0]["grads"])
    for name, g in got[0]["grads"].items():
        want = grads[name]
        np.testing.assert_allclose(
            g, want, rtol=0, err_msg=name,
            atol=1e-5 * float(np.abs(want).max()) + 1e-12)
    b1, b2 = jcfg.OPTIMIZER.BETAS
    travel = lr * float(jcfg.OPTIMIZER.NEW_NET_LRMULT)
    moved = 0
    for name, w in got[0]["weights"].items():
        np.testing.assert_array_equal(w, got[1]["weights"][name], name)
        steady = np.abs(grads[name]) >= 1e-3 * np.abs(grads[name]).max()
        err = np.abs(w - after[name])
        assert (err[steady] <= 1e-6 + 0.01 * travel).all(), name
        assert (err <= 2 * (1 - b1) / np.sqrt(1 - b2) * travel).all(), name
        moved += int(not np.array_equal(w, world2["weights"][name]))
    assert moved > 0


def test_ddp_step_with_remat_equals_without(world2):
    """``TPU.REMAT`` recomputes each ladder step in the backward
    (``torch.utils.checkpoint``, non-reentrant): DDP's hooks fire once per
    parameter (a second firing raises), and the loss, gradients and
    weights equal those without remat bit for bit."""
    for got, want in zip(world2["remat"], world2["step"]):
        assert got["losses"] == want["losses"]
        for group in ("grads", "weights"):
            assert sorted(got[group]) == sorted(want[group])
            for name, g in want[group].items():
                np.testing.assert_array_equal(got[group][name], g, name)


def test_tada2d_batch_norm_over_the_global_batch(world2):
    """A tiny TAda2D step at world 2, batch 2 a rank: BatchNorm's batch
    statistics are the global batch's (all-reduced), so the loss, every
    gradient, and every weight and running stat after the step equal
    one process's at batch 4 within 1e-5."""
    cfg, weights, batch = world2["tada_inputs"]
    one = torch_ddp_ranks.ddp_step(cfg, weights, batch)
    for rank in world2["tada"]:
        np.testing.assert_allclose(rank["losses"], one["losses"], rtol=1e-5)
        assert sorted(rank["grads"]) == sorted(one["grads"])
        for k, g in one["grads"].items():
            np.testing.assert_allclose(rank["grads"][k], g, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        assert sorted(rank["weights"]) == sorted(one["weights"])
        for k, w in one["weights"].items():
            np.testing.assert_allclose(rank["weights"][k], w, rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    moved = [k for k in one["weights"] if k.endswith("running_var")
             and not np.allclose(one["weights"][k], weights[k])]
    assert len(moved) == sum(k.endswith("running_var") for k in weights)


def test_fused_model_builds_for_more_than_one_gpu(repo_root):
    """``TPU.FUSED_TEMPORAL_NET`` with NUM_GPUS and NUM_SHARDS above one:
    the JAX package builds the model, and so does the port (each rank
    runs the fused kernels on its own batch)."""
    opts = ["TPU.FUSED_TEMPORAL_NET", "true", "NUM_GPUS", "2",
            "NUM_SHARDS", "2"]
    path = os.path.join(repo_root, TINY)
    jax_clip(jax_load_config(path, opts, make_output_dir=False))
    with torch.device("meta"):
        model = clip_dist_from_cfg(load_config(path, opts,
                                               make_output_dir=False))
    assert all(n.fused for n in model.dist_net.temporal_nets)


def test_loader_signature_records_the_world(repo_root, monkeypatch):
    """The mid-epoch signature carries the process count, the JAX
    package's third field, which was fixed at 1."""
    from dist_tpu_torch.parallel import collectives

    cfg = load_config(os.path.join(repo_root, TINY), ["TRAIN.BATCH_SIZE", "4"],
                      make_output_dir=False)
    assert cu._loader_signature(cfg, 16)[1:3] == [4, 1]
    monkeypatch.setattr(collectives, "get_world_size", lambda: 2)
    assert cu._loader_signature(cfg, 16)[1:3] == [4, 2]


def test_mixup_pairs_stay_inside_a_rank():
    """Kept on purpose (ROADMAP.md C): the JAX step flips the global batch
    (``dist_tpu/data/mixup.py:118``), so its pairs cross shards; the port's
    step flips each rank's batch, as the reference did on each GPU. The
    draws come from ``step_generator(RANDOM_SEED + 1, step)``, the same on
    every rank. At world 1 the port equals JAX; at world 2 rank r's rows
    are JAX's mixup of rank r's rows alone, not its global batch's."""
    g0, g1 = step_generator(1, 5), step_generator(1, 5)
    assert torch.equal(torch.rand(4, generator=g0),
                       torch.rand(4, generator=g1))
    for kind in ("mixup", "cutmix"):
        key, jmc, d = _case(kind)
        mc = mixup.MixupConfig(**dataclasses.asdict(jmc))
        rng = np.random.default_rng(3)
        video = rng.standard_normal((GLOBAL_BATCH, 3, 14, 10, 3)).astype(
            np.float32)
        labels = rng.integers(0, mc.num_classes, GLOBAL_BATCH)
        want_v, want_t = jmix.mixup_batch(key, jnp.asarray(video),
                                          jnp.asarray(labels), jmc)
        got_v, got_t = mixup.apply(torch.from_numpy(video),
                                   torch.from_numpy(labels), d, mc)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        half = GLOBAL_BATCH // 2
        for r in range(2):
            rows = slice(r * half, (r + 1) * half)
            got_v, got_t = mixup.apply(torch.from_numpy(video[rows]),
                                       torch.from_numpy(labels[rows]), d, mc)
            local_v, local_t = jmix.mixup_batch(
                key, jnp.asarray(video[rows]), jnp.asarray(labels[rows]), jmc)
            np.testing.assert_array_equal(got_v.numpy(), np.asarray(local_v))
            np.testing.assert_array_equal(got_t.numpy(), np.asarray(local_t))
            assert not np.array_equal(got_v.numpy(),
                                      np.asarray(want_v)[rows])
