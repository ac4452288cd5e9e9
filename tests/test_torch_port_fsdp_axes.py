"""``TPU.FSDP`` composed with the model axis and with the pipe axis on the
CPU: four gloo ranks spawned once for the file through the port's
launcher, laid out job by job (``torch_parallel_ranks.mesh_runs``) as
data 2 x model 2 and data 2 x pipe 2, each with FSDP2 over its data
group. One global batch of 8, each data shard on its 4 rows.

- data 2 x model 2: the tiny CLIP+DiST 128 wide of ``_tp.py`` (``R.WIDE``:
  the model axis splits heads), fp32, EMA on.
- data 2 x pipe 2: the tiny CLIP fine-tune of ``_pipeline.py`` (``FT``,
  its tower trained through the schedule), fp32, EMA on; and the tiny
  DiST's eval and first step, its frozen tower pipelined.

Each runs two train steps and the evals after them, plain and EMA,
against the one-process run; the first step against the JAX package's
``_jax_step(..., fsdp=True)`` on its 8-device mesh (data 4 x model 2,
data 4 x pipe 2, per-shard batch 2); each rank's elements of every leaf
of 8192 elements or more against the JAX package's per-device elements
after ``shard_params(fsdp=True)`` on 4 devices; the pipelined stage
gathered once a step; and the checkpoint, written under the composition,
the one-rank run's file, which resumes in one process and under the
plain axis, and the other way round."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dist_tpu.models.clip.model as jax_clip_model
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.optim import optimizer as jopt
from dist_tpu.parallel.mesh import build_mesh, shard_params
from dist_tpu.tasks import state as jstate
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as R
from tests.test_torch_port_clip_ft import _variables as clip_ft_variables
from tests.test_torch_port_ddp import STEP, TINY, _jax_step, _step_inputs
from tests.test_torch_port_pipeline import EMA, FT, FT_OPTS
from tests.test_torch_port_tp import WIDE_OPTS, _inputs as wide_inputs

SPAWN_TIMEOUT_S = 600
STEPS = 2
FSDP = ["TPU.FSDP", "true", "TPU.MESH.DATA", "2"]
TP = ["TPU.MESH.MODEL", "2"]
PIPE = ["TPU.MESH.PIPE", "2"]
FUSED = ["TPU.FUSED_TEMPORAL_NET", "true"]
# the JAX package's step on its 8-device mesh: per-shard batch 2
JAX_BATCH = ["TRAIN.BATCH_SIZE", "2"]
# the JAX rule: leaves of this many elements or more shard over data
FSDP_MIN_SIZE = 8192
# fp32 in another summation order: the losses, the scores, the
# gradients (of each leaf's largest value); the tolerances of
# _tp.py, _pipeline.py and _fsdp.py
LOSS_REL = 1e-5
SCORE_ATOL = 1e-5
GRAD_REL = 1e-5
# the fine-tune's weights after AdamW steps in another summation order
# (_pipeline.py's bound: an element whose exact gradient is zero steps
# by +-lr on rounding noise, BASE_LR 0.01)
ADAM_STEP_BOUND = 0.01 * STEPS


def _wide_arch(mp):
    mp.setitem(jax_clip_model.ARCHITECTURES, R.WIDE,
               jax_clip_model.CLIPArchitecture(32, 64, 2, 128, 16, 77,
                                               49408, 128, 2, 2))


def _travel(jcfg, lr):
    """AdamW's largest step of an element, and the bound on one step's
    difference where a near-zero gradient's sign flips."""
    b1, b2 = jcfg.OPTIMIZER.BETAS
    travel = lr * float(jcfg.OPTIMIZER.NEW_NET_LRMULT)
    return travel, 2 * (1 - b1) / np.sqrt(1 - b2) * travel


def _key(entry):
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return getattr(entry, attr)
    return entry


def _jax_leaves(jcfg, variables):
    """{device index: {torch name: (elements of the parameter, of its two
    AdamW moments)}} of each of 4 devices (index ``(d * pipe + p) * model
    + m``, the port's rank) after the JAX package's ``shard_params(...,
    fsdp=True)`` of the train state on ``build_mesh(jcfg, devices=
    jax.devices()[:4])``: a mask of the elements each device holds, taken
    across to the torch names by ``state_dict_from_jax`` (a moment's mask
    under its parameter's path, the path after ``mu`` or ``nu``)."""
    tx, _ = jopt.construct_optimizer(jcfg, variables, 4)
    mesh = build_mesh(jcfg, devices=jax.devices()[:4])
    with mesh:
        state = shard_params(mesh, jstate.create_train_state(variables, tx),
                             fsdp=True)
    flat = jax.tree_util.tree_leaves_with_path(state.variables)
    treedef = jax.tree_util.tree_structure(state.variables)
    paths = [tuple(_key(e) for e in path) for path, _ in flat]
    moments = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(state.opt_state):
        keys = [_key(e) for e in path]
        for kind in ("mu", "nu"):
            if kind in keys:
                suffix = tuple(keys[keys.index(kind) + 1:])
                moments.setdefault(suffix, []).append(leaf)
    assert moments and set(moments) <= set(paths)

    def mask(leaf, device):
        m = np.zeros(leaf.shape, np.float32)
        m[leaf.sharding.devices_indices_map(leaf.shape)[device]] = 1
        return m

    def counts(masks):
        return {k: int(np.asarray(v).sum()) for k, v in state_dict_from_jax(
            jax.tree_util.tree_unflatten(treedef, masks)).items()}

    out = {}
    for i, device in enumerate(mesh.devices.flat):
        held = counts([mask(leaf, device) for _, leaf in flat])
        held_moments = counts([
            sum((mask(m, device) for m in moments.get(path, ())),
                np.zeros(leaf.shape, np.float32))
            for path, (_, leaf) in zip(paths, flat)])
        out[i] = {k: (held[k], held_moments[k]) for k in held}
    return out


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads in this process while the file's fixture runs
    (the four spawned ranks share them): the suite runs in several worker
    processes at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(repo_root, tmp_path_factory, few_threads):
    tiny, ft = os.path.join(repo_root, TINY), os.path.join(repo_root, FT)
    # the JAX side: the wide model under data 4 x model 2, the DiST step
    # under data 4 x pipe 2, each with the state placed by FSDP
    with pytest.MonkeyPatch.context() as mp:
        _wide_arch(mp)
        wjcfg, wparams, wbatch = wide_inputs(repo_root)
        jax_tp = _jax_step(wjcfg, wparams, wbatch, fsdp=True)
        jax_tp_leaves = _jax_leaves(
            jax_load_config(tiny, WIDE_OPTS + TP, make_output_dir=False),
            {"params": wparams})
    djcfg, dparams, dbatch = _step_inputs(repo_root)
    pjcfg = jax_load_config(tiny, STEP + PIPE + JAX_BATCH,
                            make_output_dir=False)
    jax_pipe = _jax_step(pjcfg, dparams, dbatch, fsdp=True)
    jax_pipe_leaves = _jax_leaves(
        jax_load_config(ft, FT_OPTS + PIPE, make_output_dir=False),
        jax.tree_util.tree_map(jnp.asarray, clip_ft_variables()))

    R.register_wide()
    wweights = {k: np.asarray(v, np.float32)
                for k, v in state_dict_from_jax(wparams).items()}
    dweights = {k: np.asarray(v, np.float32)
                for k, v in state_dict_from_jax(dparams).items()}
    wide = {m: load_config(tiny, WIDE_OPTS + opts, make_output_dir=False)
            for m, opts in (("plain", []), ("axis", TP),
                            ("fsdp", TP + FSDP))}
    fine = {m: load_config(ft, FT_OPTS + EMA + opts, make_output_dir=False)
            for m, opts in (("plain", []), ("axis", PIPE),
                            ("fsdp", PIPE + FSDP))}
    dist_cfg = load_config(tiny, STEP + FUSED + PIPE + FSDP,
                           make_output_dir=False)
    dist_plain = load_config(tiny, STEP + FUSED, make_output_dir=False)
    ft_weights = {k: v.numpy() for k, v in build_model(
        fine["plain"], device="cpu", seed=0).module.state_dict().items()}
    rng = np.random.default_rng(3)
    ft_batch = {"video": rng.integers(0, 256, (8, 4, 64, 64, 3),
                                      dtype=np.uint8),
                "labels": rng.integers(0, 174, 8).astype(np.int64)}
    out = str(tmp_path_factory.mktemp("fsdp_axes"))
    group = launch.launch_task(wide["fsdp"], R.mesh_runs, ([
        (wide["fsdp"], "composed",
         (wide["fsdp"], wide["axis"], wide["plain"], wweights, wbatch, STEPS,
          os.path.join(out, "tp"))),
        (fine["fsdp"], "composed",
         (fine["fsdp"], fine["axis"], fine["plain"], ft_weights, ft_batch,
          STEPS, os.path.join(out, "pipe"))),
        (dist_cfg, "eval_scores", (dist_cfg, dweights, dbatch)),
        (dist_cfg, "train_steps", (dist_cfg, dweights, dbatch, 1)),
    ],), device="cpu", timeout=SPAWN_TIMEOUT_S)
    one = {"tp": R.train_steps(wide["plain"], wweights, wbatch, STEPS,
                               os.path.join(out, "one_tp"), evals=True),
           "pipe": R.train_steps(fine["plain"], ft_weights, ft_batch, STEPS,
                                 os.path.join(out, "one_pipe"), evals=True),
           "dist_eval": R.eval_scores(dist_plain, dweights, dbatch)}
    return {"group": group, "one": one,
            "jax": {"tp": (wjcfg, jax_tp), "pipe": (pjcfg, jax_pipe)},
            "jax_leaves": {"tp": jax_tp_leaves, "pipe": jax_pipe_leaves}}


JOBS = {"tp": 0, "pipe": 1}


@pytest.mark.parametrize("axis", ["tp", "pipe"])
def test_steps_and_evals_match_one_process(runs, axis):
    """Each step's loss, the first step's gradients (every trainable leaf,
    full), the evals after each step, plain and EMA, against the one
    process at the global batch; every rank alike."""
    one = runs["one"][axis]
    ranks = [g[JOBS[axis]] for g in runs["group"]]
    r0 = ranks[0]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=LOSS_REL)
    assert one["grads"]
    for k, g in one["grads"].items():
        np.testing.assert_allclose(r0["grads"][k], g, rtol=0, err_msg=k,
                                   atol=GRAD_REL * float(np.abs(g).max())
                                   + 1e-12)
    for r in ranks:
        assert r["losses"] == r0["losses"]
        for got, want in zip(r["evals"] + r["ema_evals"],
                             one["evals"] + one["ema_evals"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
        for k, v in r["weights"].items():
            np.testing.assert_array_equal(v, r0["weights"][k], k)


@pytest.mark.parametrize("axis", ["tp", "pipe"])
def test_first_step_matches_jax_fsdp(runs, axis):
    """The first step against JAX's with the state placed by
    ``shard_params(fsdp=True)``: data 4 x model 2 on the wide model, data 4
    x pipe 2 on the DiST step (its frozen tower pipelined): the loss,
    every trainable gradient and the weights after it."""
    jcfg, (loss, grads, after, lr) = runs["jax"][axis]
    got = runs["group"][0][0 if axis == "tp" else 3]
    assert got["losses"][0] == pytest.approx(loss, rel=LOSS_REL)
    travel, flip = _travel(jcfg, lr)
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


def test_dist_eval_under_pipe_and_fsdp(runs):
    """The DiST eval, its frozen tower pipelined and every weight sharded
    over data: every rank's scores of the global batch against one
    process's; K2's pack made on every call under FSDP."""
    for g in runs["group"]:
        np.testing.assert_allclose(g[2], runs["one"]["dist_eval"], rtol=0,
                                   atol=SCORE_ATOL)
        assert g[3]["pack_every_call"] and all(g[3]["pack_every_call"])
        assert g[0]["pack_every_call"] and all(g[0]["pack_every_call"])


@pytest.mark.parametrize("axis", ["tp", "pipe"])
def test_each_rank_holds_what_jax_places_on_its_device(runs, axis):
    """Every leaf of 8192 elements or more: each rank holds the JAX
    package's per-device elements of the parameter and of its two AdamW
    moments (device ``(d * pipe + p) * model + m`` is rank r); of a
    smaller leaf no more than the device does."""
    jax_leaves = runs["jax_leaves"][axis]
    big = 0
    for rank, g in enumerate(runs["group"]):
        r = g[JOBS[axis]]
        want = jax_leaves[rank]
        assert set(r["local_leaves"]) <= set(want)
        for name, (params, moments) in want.items():
            got = r["local_leaves"].get(name, 0)
            got_moments = r["local_moment_leaves"].get(name, 0)
            size = int(np.prod(runs["one"][axis]["weights"][name].shape))
            if size >= FSDP_MIN_SIZE:
                big += 1
                assert (got, got_moments) == (params, moments), (rank, name)
            else:
                assert got <= params and got_moments <= moments, (rank, name)
    assert big


def test_pipelined_stage_is_gathered_once_a_step(runs):
    """Under data x pipe with FSDP a step all-gathers and reduce-scatters
    once for the stage (one unit kept gathered across the schedule's
    ticks) and once for the root, however many ticks the schedule runs
    (3 here: 2 microbatches, 2 stages); the fine-tune's idle text tower
    is neither gathered nor reduced."""
    for g in runs["group"]:
        assert g[JOBS["pipe"]]["collectives"] == \
            [{"all_gather": 2, "reduce_scatter": 2}] * STEPS


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _same_file(a, b, exact, what):
    """Two checkpoint payloads: the same keys, shapes, dtypes, optimizer
    ids and groups; the values equal (``exact``) or the weights and EMA
    copies within ``ADAM_STEP_BOUND`` and the moments' shapes alike."""
    assert a["step"] == b["step"] and a["epoch"] == b["epoch"], what
    for part in ("model_state", "ema"):
        assert list(a[part]) == list(b[part]), (what, part)
        for k, v in a[part].items():
            w = b[part][k]
            assert not hasattr(v, "to_local"), (what, k)
            assert v.shape == w.shape and v.dtype == w.dtype, (what, k)
            if exact:
                assert torch.equal(v, w), (what, part, k)
            elif v.is_floating_point():
                np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=0,
                                           atol=ADAM_STEP_BOUND,
                                           err_msg=f"{what} {k}")
    oa, ob = a["optimizer_state"], b["optimizer_state"]
    assert oa["param_groups"] == ob["param_groups"], what
    assert sorted(oa["state"]) == sorted(ob["state"]), what
    for i, entry in oa["state"].items():
        assert sorted(entry) == sorted(ob["state"][i]), (what, i)
        for field, v in entry.items():
            w = ob["state"][i][field]
            assert v.shape == w.shape, (what, i, field)
            if exact or field == "step":
                assert torch.equal(v, w), (what, i, field)


@pytest.mark.parametrize("axis", ["tp", "pipe"])
def test_checkpoint_is_the_one_rank_file_and_round_trips(runs, axis):
    """The file written under the composition is the one-rank run's (full
    tensors, the same keys, optimizer ids and EMA copies, the values
    within the steps' limits); a plain state and one of the plain axis
    resume it and write it again tensor for tensor, and the composition
    resumes each of their files and writes it again tensor for tensor."""
    r0 = runs["group"][0][JOBS[axis]]
    composed = _load(r0["checkpoint"])
    _same_file(composed, _load(runs["one"][axis]["checkpoint"]), exact=False,
               what=f"{axis} against one rank")
    for name, path in r0["round_trips"].items():
        _same_file(_load(path), composed, exact=True, what=f"{axis} {name}")
