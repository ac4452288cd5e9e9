"""The GPipe ``pipe`` axis (``parallel/pipeline.py``) on the CPU: four
gloo ranks, data 2 x pipe 2, spawned once for the file through the port's
launcher.

- ``pipeline_stack`` on the JAX pipeline test's toy stack (8 layers of
  ``tanh(x @ w + b) + x``, 8 rows of 5 x 16) against the sequential
  stack and the JAX package's scan, for several microbatch counts (one
  clamped, with the JAX package's warning), with and without taps; then
  the gradients of the weights and the input.
- The tiny CLIP+DiST model's eval forward with its frozen tower
  pipelined, and two train steps of the unfrozen tower (the CLIP
  fine-tune's path, its blocks trained through the schedule), also with
  the first stage's block frozen by name, against one process at the
  same global batch.
- Each rank holds its own stage's blocks alone: its parameter and AdamW
  moment elements are the JAX package's per-device elements after
  ``shard_params`` on its 8-device mesh of data 4 x pipe 2.
- A checkpoint written under pipe 2 (EMA on) is the one-rank run's file:
  the same keys, shapes and optimizer ids, its values within the steps'
  limits; it resumes on a plain state which writes it again tensor for
  tensor, and that file resumes on the pipe ranks, each keeping its own
  stage, and is written again tensor for tensor.
- What stays refused: pipe on a backbone other than CLIP's, pipe with a
  model axis (with ``TPU.FSDP`` too), and a tower whose layers the stages
  do not divide."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.parallel import launch, mesh, pipeline
from tests import torch_parallel_ranks as R
from tests.test_torch_port_ddp import STEP, TINY, _step_inputs
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.optim import optimizer as jopt
from dist_tpu.parallel.mesh import build_mesh, shard_params
from dist_tpu.tasks import state as jstate
from tests.test_torch_port_clip_ft import _variables as clip_ft_variables

SPAWN_TIMEOUT_S = 300
PIPE = ["TPU.MESH.PIPE", "2", "TPU.MESH.DATA", "2"]
# the CLIP fine-tune (its tower trained) at test_torch_port_clip_ft.py's
# tiny geometry, in fp32
FT = "configs/projects/dist/vit_base_16_ssv2.yaml"
FT_OPTS = ["VIDEO.HEAD.NAME", "ClipVideoHeadLinear",
           "VIDEO.BACKBONE.META_ARCH_NAME", "ViT-Test",
           "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
           "DATA.TEST_SCALE", "64", "DATA.TEST_CROP_SIZE", "64",
           "TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE",
           "false", "AUGMENTATION.CUTMIX.ENABLE", "false",
           "VIDEO.HEAD.DROPOUT_RATE", "0", "OPTIMIZER.WARMUP_EPOCHS", "0",
           "OPTIMIZER.BASE_LR", "0.01"]
# (microbatches, taps): 0 is one per stage; 3 does not divide a data
# shard's 4 rows and is clamped to 2
CASES = [(0, True), (4, True), (3, True), (2, False)]
# the checkpoint round trips: the fine-tune with its EMA copy
EMA = ["MODEL.EMA.ENABLE", "true", "MODEL.EMA.DECAY", "0.9"]
# JAX's mesh for the per-device elements: 8 devices, data 4 x pipe 2
JAX_PIPE = ["TPU.MESH.PIPE", "2"]
STEPS = 2
# fp32 in another order: the toy's outputs against JAX's scan (the JAX
# pipeline test's), the model's scores and losses, and every gradient (of
# its leaf's largest value)
TOY_RTOL, TOY_ATOL = 2e-5, 1e-5
SCORE_ATOL = 1e-5
LOSS_REL = 1e-5
GRAD_REL = 1e-5
# weights after AdamW steps in another summation order: an element whose
# exact gradient is zero (the key bias: softmax ignores it) steps by
# +-lr on rounding noise in either run, so two runs may differ there by
# lr a step (BASE_LR 0.01 in FT_OPTS)
ADAM_STEP_BOUND = 0.01 * STEPS
# AdamW's moments after the steps, of their largest value: the second
# step's gradient is taken at weights that differ already (5e-5 on the
# CPU)
MOMENT_REL = 1e-4


def _toy():
    """The JAX pipeline test's toy: 8 layers, 8 rows of 5 x 16, and the
    taps' cotangent ``z``, seeded with numpy."""
    rng = np.random.default_rng(0)
    L, N, T, D = 8, 8, 5, 16
    w = (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((N, T, D)).astype(np.float32)
    z = rng.standard_normal((L, N, T, D)).astype(np.float32)
    return w, b, x, z


def _jax_toy(w, b, x, z):
    """JAX's sequential scan of the toy, its taps and the gradients of
    the same loss (``notaps``: of the loss without the taps' term)."""
    def body(p, c):
        return jnp.tanh(c @ p["w"] + p["b"]) + c

    def seq(params, x):
        def layer(c, p):
            y = body(p, c)
            return y, y
        return jax.lax.scan(layer, x, params)

    def loss(params, x):
        y, taps = seq(params, x)
        return (y ** 2).sum() + (taps * z).sum()

    def loss_y(params, x):
        return (seq(params, x)[0] ** 2).sum()

    params = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    y, taps = jax.jit(seq)(params, jnp.asarray(x))
    out = {"y": np.asarray(y), "taps": np.moveaxis(np.asarray(taps), 0, 1)}
    for key, fn in (("taps", loss), ("notaps", loss_y)):
        g, gx = jax.jit(jax.grad(fn, argnums=(0, 1)))(params, jnp.asarray(x))
        out[key + "_grads"] = {"gw": np.asarray(g["w"]),
                               "gb": np.asarray(g["b"]), "gx": np.asarray(gx)}
    return out


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
    _, params, batch = _step_inputs(repo_root)
    weights = {k: np.asarray(v, np.float32)
               for k, v in state_dict_from_jax(params).items()}
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, STEP + PIPE, make_output_dir=False)
    plain = load_config(path, STEP, make_output_dir=False)
    ft = os.path.join(repo_root, FT)
    train_cfg = load_config(ft, FT_OPTS + PIPE, make_output_dir=False)
    plain_train = load_config(ft, FT_OPTS, make_output_dir=False)
    ft_weights = {k: v.numpy() for k, v in build_model(
        plain_train, device="cpu", seed=0).module.state_dict().items()}
    # the fine-tune with stage 0's block (and the text tower's first)
    # frozen by name, stage 1's trained
    frozen_train = load_config(ft, FT_OPTS + PIPE, make_output_dir=False)
    plain_frozen = load_config(ft, FT_OPTS, make_output_dir=False)
    for c in (frozen_train, plain_frozen):
        c.TRAIN.FIXED_WEIGHTS = ["0"]
    rng = np.random.default_rng(3)
    ft_batch = {"video": rng.integers(0, 256, (8, 4, 64, 64, 3),
                                      dtype=np.uint8),
                "labels": rng.integers(0, 174, 8).astype(np.int64)}
    ckpt_cfg = load_config(ft, FT_OPTS + EMA + PIPE, make_output_dir=False)
    ckpt_plain = load_config(ft, FT_OPTS + EMA, make_output_dir=False)
    out = str(tmp_path_factory.mktemp("pipe_ckpt"))
    w, b, x, z = _toy()
    group = launch.launch_task(cfg, R.group_runs, ([
        ("pipeline_toy", (w, b, x, z, CASES)),
        ("eval_scores", (cfg, weights, batch)),
        ("train_steps", (train_cfg, ft_weights, ft_batch, STEPS)),
        ("train_steps", (frozen_train, ft_weights, ft_batch, STEPS)),
        ("pipe_checkpoints", (ckpt_cfg, ckpt_plain, ft_weights, ft_batch,
                              STEPS, out))],),
        device="cpu", timeout=SPAWN_TIMEOUT_S)
    one_ckpt = R.train_steps(
        load_config(ft, FT_OPTS + EMA, make_output_dir=False), ft_weights,
        ft_batch, STEPS, os.path.join(out, "one"))["checkpoint"]
    return {"group": group, "jax_toy": _jax_toy(w, b, x, z),
            "one_checkpoint": one_ckpt,
            "jax_elements": _jax_elements(repo_root),
            "toy": R.pipeline_toy(w, b, x, z, CASES),
            "eval": R.eval_scores(plain, weights, batch),
            "steps": R.train_steps(plain_train, ft_weights, ft_batch, STEPS),
            "frozen_steps": R.train_steps(plain_frozen, ft_weights, ft_batch,
                                          STEPS)}


def _jax_elements(repo_root):
    """{stage: (parameter elements, AdamW moment elements)} of one device
    of each pipe stage, after the JAX package's ``shard_params`` of the
    fine-tune's train state on its 8-device mesh (data 4 x pipe 2)."""
    jcfg = jax_load_config(os.path.join(repo_root, FT), FT_OPTS + JAX_PIPE,
                           make_output_dir=False)
    variables = jax.tree_util.tree_map(jnp.asarray, clip_ft_variables())
    tx, _ = jopt.construct_optimizer(jcfg, variables, 4)
    mesh = build_mesh(jcfg, devices=jax.devices())
    with mesh:
        state = shard_params(mesh, jstate.create_train_state(variables, tx))
    assert mesh.shape["pipe"] == 2 and mesh.shape["data"] == 4

    def on(leaves, device):
        return sum(s.data.size for leaf in leaves
                   for s in leaf.addressable_shards if s.device == device)

    moments = [leaf for path, leaf in
               jax.tree_util.tree_leaves_with_path(state.opt_state)
               if any(getattr(p, "name", None) in ("mu", "nu") for p in path)]
    assert moments
    params = jax.tree_util.tree_leaves(state.variables)
    return {stage: (on(params, mesh.devices[0, stage, 0]),
                    on(moments, mesh.devices[0, stage, 0]))
            for stage in (0, 1)}


@pytest.mark.parametrize("case", range(len(CASES)))
def test_pipeline_stack_matches_the_sequential_stack(runs, case):
    """Every rank's output and taps against the port's sequential stack
    and JAX's scan, and the gradients of the weights and the input."""
    want, jax_toy = runs["toy"][case], runs["jax_toy"]
    taps = CASES[case][1]
    jax_ref = {**jax_toy, **jax_toy["taps_grads" if taps else "notaps_grads"]}
    for ranks in runs["group"]:
        got = ranks[0][case]
        for key in ("y",) + (("taps",) if taps else ()):
            for ref in (want, jax_ref):
                np.testing.assert_allclose(got[key], ref[key], rtol=TOY_RTOL,
                                           atol=TOY_ATOL, err_msg=key)
        for key in ("gw", "gb", "gx"):
            for ref in (want, jax_ref):
                np.testing.assert_allclose(
                    got[key], ref[key], rtol=0, err_msg=key,
                    atol=GRAD_REL * float(np.abs(ref[key]).max()))


def test_microbatches_clamp_with_the_jax_warning(caplog):
    """A requested count that does not divide the rows is clamped to the
    largest divisor below it, with the JAX package's warning; 0 means one
    per stage."""
    assert pipeline.microbatches(8, 2, 0) == 2
    assert pipeline.microbatches(8, 4, 8) == 8
    with caplog.at_level("WARNING"):
        assert pipeline.microbatches(4, 2, 3) == 2
    assert "clamped microbatches 3 -> 2" in caplog.text


def test_model_eval_under_pipe_matches_one_process(runs):
    """The frozen tower pipelined: every rank's scores of the global batch
    against one process's."""
    for ranks in runs["group"]:
        np.testing.assert_allclose(ranks[1], runs["eval"], rtol=0,
                                   atol=SCORE_ATOL)


def test_train_steps_under_pipe_match_one_process(runs):
    """The unfrozen tower trained through the schedule: each step's loss,
    the first step's gradients (the tower's from its own stage, on every
    rank), the weights after; every rank alike."""
    _steps_match(runs["steps"], [r[2] for r in runs["group"]])


def test_train_steps_with_the_first_stage_frozen(runs):
    """Stage 0's block frozen by ``TRAIN.FIXED_WEIGHTS``, stage 1's
    trained: stage 1's gradients still reach the rank of stage 0, and
    every rank steps the weights of one process."""
    one = runs["frozen_steps"]
    assert not any(k.startswith("visual.transformer.resblocks.0.")
                   for k in one["grads"])
    assert any(k.startswith("visual.transformer.resblocks.1.")
               for k in one["grads"])
    _steps_match(one, [r[3] for r in runs["group"]])


def _steps_match(one, ranks):
    """Each step's loss, the first step's gradients (the tower's from its
    own stage, on every rank), the weights after; every rank alike."""
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=LOSS_REL)
    assert any(k.startswith("visual.transformer.") for k in one["grads"])
    for k, g in one["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][k], g, rtol=0,
                                   err_msg=k,
                                   atol=GRAD_REL * float(np.abs(g).max())
                                   + 1e-12)
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for k, v in r["weights"].items():
            np.testing.assert_array_equal(v, ranks[0]["weights"][k], k)


def test_each_rank_holds_its_stage_as_jax_places_it(runs):
    """Each rank's parameter and AdamW moment elements are the JAX
    package's on a device of the same pipe stage, its blocks its own
    stage's alone; the one-process run holds the whole tower."""
    one = runs["steps"]
    stage_elements = runs["jax_elements"]
    assert stage_elements[0] == stage_elements[1]
    for rank, ranks in enumerate(runs["group"]):
        r = ranks[2]
        stage = rank % 2
        assert (r["local_params"], r["local_moments"]) == \
            stage_elements[stage], rank
        blocks = {k.split(".")[3] for k in r["held"][0]
                  if k.startswith("visual.transformer.resblocks.")}
        assert blocks == {str(stage)}, (rank, blocks)
        assert r["total_params"] == one["total_params"]
    per_block = (one["local_params"] - stage_elements[0][0])
    assert per_block > 0 and one["local_params"] == one["total_params"]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_file(a, b, exact, what):
    """Two checkpoint payloads: the same keys, shapes, dtypes, optimizer
    ids and groups; the values equal (``exact``) or within the steps'
    limits (the weights and their EMA copies within ``ADAM_STEP_BOUND``,
    the moments within ``MOMENT_REL`` of their largest value)."""
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"], what
    for part in ("model_state", "ema"):
        assert list(a[part]) == list(b[part]), (what, part)
        for k, v in a[part].items():
            w = b[part][k]
            assert v.shape == w.shape and v.dtype == w.dtype, (what, k)
            if exact:
                assert torch.equal(v, w), (what, part, k)
            elif v.is_floating_point():
                np.testing.assert_allclose(
                    v.numpy(), w.numpy(), rtol=0, err_msg=f"{what} {k}",
                    atol=ADAM_STEP_BOUND)
    oa, ob = a["optimizer_state"], b["optimizer_state"]
    assert [{k: v for k, v in g.items()} for g in oa["param_groups"]] == \
        [{k: v for k, v in g.items()} for g in ob["param_groups"]], what
    assert sorted(oa["state"]) == sorted(ob["state"]), what
    for i, entry in oa["state"].items():
        assert sorted(entry) == sorted(ob["state"][i]), (what, i)
        for field, v in entry.items():
            w = ob["state"][i][field]
            if exact or field == "step":
                assert torch.equal(v, w), (what, i, field)
            else:
                np.testing.assert_allclose(
                    v.numpy(), w.numpy(), rtol=0, err_msg=f"{what} {i}",
                    atol=MOMENT_REL * float(w.abs().max()) + 1e-12)


def test_pipe_checkpoint_is_the_one_rank_file(runs):
    """The checkpoint written under pipe 2 holds every block, its moments
    and EMA copies, under the one-rank run's keys and optimizer ids."""
    pipe = _load(runs["group"][0][4]["pipe"]["checkpoint"])
    one = _load(runs["one_checkpoint"])
    assert any(k.startswith("visual.transformer.resblocks.1.")
               for k in pipe["model_state"])
    _assert_same_file(pipe, one, exact=False, what="pipe against one rank")


def test_pipe_checkpoint_round_trips(runs):
    """Pipe -> one rank -> file: tensor for tensor the pipe file; that
    file -> pipe ranks -> file: tensor for tensor again; each pipe rank
    resumed holds what it held after its steps, its own stage alone."""
    rec = runs["group"][0][4]
    pipe = _load(rec["pipe"]["checkpoint"])
    _assert_same_file(_load(rec["plain_checkpoint"]), pipe, exact=True,
                      what="pipe -> plain")
    _assert_same_file(_load(rec["pipe_again_checkpoint"]), pipe, exact=True,
                      what="plain -> pipe")
    for ranks in runs["group"]:
        r = ranks[4]
        held, moments = r["pipe"]["held"]
        got, got_moments = r["resumed_held"]
        assert list(got) == list(held)
        for k, v in held.items():
            np.testing.assert_array_equal(got[k], v, k)
            np.testing.assert_array_equal(got[k], pipe["model_state"][k]
                                          .numpy(), k)
        assert sorted(got_moments) == sorted(moments)
        for k, fields in moments.items():
            for f, v in fields.items():
                np.testing.assert_array_equal(got_moments[k][f], v, k)
        assert sorted(r["resumed_ema"]) == sorted(r["pipe"]["held_ema"])
        for k, v in r["pipe"]["held_ema"].items():
            np.testing.assert_array_equal(r["resumed_ema"][k], v, k)


def test_what_stays_refused(repo_root):
    """Pipe on a non-CLIP backbone (as JAX's ``build_model`` asserts),
    pipe with a model axis (as ``build_mesh`` asserts), with or without
    ``TPU.FSDP``, and a model built
    with a pipe axis run outside a group of that pipe axis."""
    tada = load_config(os.path.join(
        repo_root, "configs/projects/tada/k400/tada2d_8x8.yaml"),
        ["TPU.MESH.PIPE", "2"], make_output_dir=False)
    with pytest.raises(ValueError, match="only wired into the CLIP tower"):
        build_model(tada, device="cpu")
    both = load_config(os.path.join(repo_root, TINY),
                       ["TPU.MESH.PIPE", "2", "TPU.MESH.MODEL", "2"],
                       make_output_dir=False)
    with pytest.raises(ValueError, match="not composed"):
        mesh.data_axis_size(both, 4)
    both_fsdp = load_config(os.path.join(repo_root, TINY),
                            ["TPU.MESH.PIPE", "2", "TPU.MESH.MODEL", "2",
                             "TPU.FSDP", "true"], make_output_dir=False)
    with pytest.raises(ValueError, match="not composed"):
        mesh.data_axis_size(both_fsdp, 8)
    cfg = load_config(os.path.join(repo_root, TINY), ["TPU.MESH.PIPE", "2"],
                      make_output_dir=False)
    model = build_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs a process group"):
        model.module.visual(torch.zeros(1, 4, 64, 64, 3))
