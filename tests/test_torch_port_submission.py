"""The port's submission task (``dist_tpu_torch/tasks/submission.py``)
against the JAX package's ``dist_tpu.tasks.submission.submission_test``,
each run through its own run list (``TASK_TYPE: submission``, 10 x 3
views) on synthetic clips, on the CPU, with the same weights: seeded
JAX variables given to the JAX task in place of its init and brought
across to a ``.pyth`` for the port.

- One head (a tiny TAda2D with ``BaseHead``): the generic JSON, version
  0.1, the same videos, each video's 30-view score sums within
  ``SCORE_ATOL`` (fp32 scores summed in another order).
- The EPIC pair (a tiny ir-CSN with ``BaseHeadx2`` [5, 7]): version 0.2
  with the supervision-level fields, the same video names, verb and
  noun scores within ``SCORE_ATOL``, every action of the verb x noun
  product (35 < 100) within ``SCORE_ATOL`` of the product's scale.
- Without a card the task raises, as every entry point does.
- On the mesh: two gloo ranks spawned once for the file, the tiny DiST
  128 wide (``torch_parallel_ranks.WIDE``: the model axis splits heads)
  under ``TPU.MESH.MODEL 2`` and under ``TPU.FSDP true TPU.MESH.DATA 2``:
  the results file of one process, each rank holding half of every
  weight the model axis splits or FSDP shards."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dist_tpu.tasks.submission as jax_submission
from dist_tpu.config import config as jax_config
from dist_tpu.models.base.models import build_model as jax_build_model
from dist_tpu.tasks.state import TrainState
from dist_tpu_torch import run
from dist_tpu_torch.config import config
from dist_tpu_torch.models.backbones.convert import state_dict_from_jax
from dist_tpu_torch.models.base.models import build_backbone_on_meta
from dist_tpu_torch.tasks.submission import submission_test
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.parallel import launch
from tests import torch_parallel_ranks as R
from tests.test_torch_port_resnet3d import jax_variables
from tests.test_torch_port_test_task import _jax_run_module

SCORE_ATOL = 1e-4
COMMON = ["DATA.SYNTHETIC", "true", "TASK_TYPE", "submission",
          "SUBMISSION.ENABLE", "true", "TEST.NUM_SAMPLES_LIMIT", "2",
          "TEST.BATCH_SIZE", "10", "TRAIN.CHECKPOINT_FILE_PATH", "",
          "VIDEO.HEAD.DROPOUT_RATE", "0.0", "LOG_MODEL_INFO", "false",
          "DATA_LOADER.NUM_WORKERS", "2"]
CASES = {
    "one_head": ("configs/projects/tada/k400/tada2d_8x8.yaml",
                 ["VIDEO.BACKBONE.DEPTH", "18",
                  "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
                  "DATA.NUM_INPUT_FRAMES", "4", "DATA.TEST_SCALE", "32",
                  "DATA.TEST_CROP_SIZE", "32",
                  "VIDEO.HEAD.NUM_CLASSES", "7"], (4, 32)),
    "epic_pair": ("configs/projects/tada/csn_ek100.yaml",
                  ["VIDEO.BACKBONE.DEPTH", "10",
                   "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
                   "DATA.NUM_INPUT_FRAMES", "8", "DATA.TEST_SCALE", "32",
                   "DATA.TEST_CROP_SIZE", "32",
                   "VIDEO.HEAD.NUM_CLASSES", "[5, 7]"], (8, 32)),
}


def _results(repo_root, tmp_path, case):
    """(port's JSON, JAX's JSON) of one case's submission run list."""
    path, opts, (frames, crop) = CASES[case]
    path = os.path.join(repo_root, path)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(pout)
    jcfg = jax_config.load_config(path, COMMON + opts + ["OUTPUT_DIR", jout])
    jmodel = jax_build_model(jcfg)
    variables = jax_variables(
        jmodel, 3, {"video": jnp.zeros((1, frames, crop, crop, 3))})

    def init_state(cfg, model, sample_batch):
        return TrainState(step=jnp.zeros((), jnp.int32), variables=variables,
                          opt_state=(), ema_variables=None)

    entries = _jax_run_module(repo_root)._prepare_data(jcfg)
    assert [f.__name__ for _, f in entries] == ["submission_test"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_submission, "_init_test_state", init_state)
        want_path = entries[0][1](entries[0][0])

    pcfg = config.load_config(path, COMMON + opts, make_output_dir=False)
    sd = state_dict_from_jax(variables, build_backbone_on_meta(pcfg))
    ckpt = os.path.join(pout, "weights.pyth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    (got_path,) = run.main(["--cfg", path, "--device", "cpu", *COMMON, *opts,
                            "OUTPUT_DIR", pout,
                            "TEST.CHECKPOINT_FILE_PATH", ckpt])
    assert os.path.basename(got_path) == os.path.basename(want_path)
    with open(got_path) as f, open(want_path) as g:
        return json.load(f), json.load(g)


def test_one_head_json_matches_jax(repo_root, tmp_path):
    got, want = _results(repo_root, tmp_path, "one_head")
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"} == \
        {"version": "0.1", "challenge": "action_recognition"}
    assert sorted(got["results"]) == sorted(want["results"]) == ["0", "1"]
    for v, entry in want["results"].items():
        scores = np.asarray(got["results"][v]["scores"])
        assert scores.shape == (7,)
        # 30 softmax views summed
        np.testing.assert_allclose(scores.sum(), 30.0, rtol=1e-5)
        np.testing.assert_allclose(scores, entry["scores"], atol=SCORE_ATOL)


def test_epic_pair_json_matches_jax(repo_root, tmp_path):
    got, want = _results(repo_root, tmp_path, "epic_pair")
    head = {"version": "0.2", "challenge": "action_recognition",
            "sls_pt": 2, "sls_tl": 3, "sls_td": 3}
    assert {k: v for k, v in got.items() if k != "results"} == head
    assert {k: v for k, v in want.items() if k != "results"} == head
    assert sorted(got["results"]) == sorted(want["results"])
    for name, entry in want["results"].items():
        mine = got["results"][name]
        for key, n in (("verb", 5), ("noun", 7)):
            assert sorted(mine[key], key=int) == [str(c) for c in range(n)]
            np.testing.assert_allclose(
                [mine[key][str(c)] for c in range(n)],
                [entry[key][str(c)] for c in range(n)], atol=SCORE_ATOL)
        assert sorted(mine["action"]) == sorted(entry["action"])
        assert len(mine["action"]) == 35
        scale = max(entry["action"].values())
        for a, s in entry["action"].items():
            assert abs(mine["action"][a] - s) <= SCORE_ATOL * scale, a
        # ranked by score, the first the largest of the outer product
        ranked = list(mine["action"].values())
        assert ranked == sorted(ranked, reverse=True)
        verb = np.asarray([mine["verb"][str(c)] for c in range(5)])
        noun = np.asarray([mine["noun"][str(c)] for c in range(7)])
        np.testing.assert_allclose(ranked[0], np.outer(verb, noun).max(),
                                   rtol=1e-12)


def test_submission_needs_a_card_or_the_cpu(repo_root):
    cfg = config.load_config(
        os.path.join(repo_root, CASES["one_head"][0]),
        COMMON + CASES["one_head"][1], make_output_dir=False)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError):
        submission_test(cfg)


# the tiny DiST 128 wide on the mesh, 2 synthetic videos of 10 x 3 views
MESH_OPTS = ["VIDEO.BACKBONE.META_ARCH_NAME", R.WIDE,
             "VIDEO.BACKBONE.DIST.INTEGRATION_DIM", "128",
             "VIDEO.BACKBONE.DIST.TEMPORAL_DIM", "16",
             "TRAIN.MIXED_PRECISION", "false", "TASK_TYPE", "submission",
             "SUBMISSION.ENABLE", "true", "TEST.NUM_SAMPLES_LIMIT", "2",
             "TEST.BATCH_SIZE", "10", "LOG_MODEL_INFO", "false"]
MODES = {"tp": ["TPU.MESH.MODEL", "2"],
         "fsdp": ["TPU.FSDP", "true", "TPU.MESH.DATA", "2"]}
# fp32 in another summation order (the model axis's sums, FSDP's
# gathered weights): a view's score, as the parallel tests' SCORE_ATOL;
# a video sums its 30 views
VIEW_ATOL = 1e-5
SPAWN_TIMEOUT_S = 600
# the weights the model axis splits (its path suffixes)
SPLIT = (r"\.attn\.(in_proj_weight|in_proj_bias|out_proj\.weight)$"
         r"|\.(mlp|ffn)\.(c_fc\.weight|c_fc\.bias|c_proj\.weight)$")


@pytest.fixture(scope="module")
def on_the_mesh(repo_root, tmp_path_factory):
    """The one process's results file, and each mode's at world 2 with
    what each rank held (one spawn for both modes)."""
    import shutil

    path = os.path.join(repo_root, "configs/projects/dist/test/tiny_synth.yaml")
    out = tmp_path_factory.mktemp("submission_mesh")
    R.register_wide()
    plain = config.load_config(path, MESH_OPTS, make_output_dir=False)
    ckpt = str(out / "weights.pyth")
    torch.save(build_model(plain, device="cpu", seed=5).module.state_dict(),
               ckpt)

    def cfg(mode, opts):
        os.makedirs(out / mode)
        return config.load_config(path, MESH_OPTS + opts + [
            "TEST.CHECKPOINT_FILE_PATH", ckpt, "OUTPUT_DIR", str(out / mode)],
            make_output_dir=False)

    cfgs = {mode: cfg(mode, opts) for mode, opts in MODES.items()}
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        ranks = launch.launch_task(
            cfgs["tp"], R.mesh_runs,
            ([(c, "submission_run", (c,)) for c in cfgs.values()],),
            device="cpu", timeout=SPAWN_TIMEOUT_S)
        one = submission_test(cfg("one", []), device="cpu")
    finally:
        torch.set_num_threads(before)
    with open(one) as f:
        want = json.load(f)
    got = {}
    for i, mode in enumerate(MODES):
        with open(ranks[0][i]["path"]) as f:
            got[mode] = json.load(f)
    yield {"want": want, "got": got,
           "ranks": {mode: [r[i] for r in ranks]
                     for i, mode in enumerate(MODES)}}
    shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_submission_on_the_mesh_matches_one_process(on_the_mesh, mode):
    """The results file at world 2 is the one process's: the same videos,
    each video's 30-view score sums within ``VIEW_ATOL`` a view."""
    want, got = on_the_mesh["want"], on_the_mesh["got"][mode]
    assert {k: v for k, v in got.items() if k != "results"} == \
        {k: v for k, v in want.items() if k != "results"}
    assert sorted(got["results"]) == sorted(want["results"]) == ["0", "1"]
    for v, entry in want["results"].items():
        np.testing.assert_allclose(got["results"][v]["scores"],
                                   entry["scores"], rtol=0,
                                   atol=30 * VIEW_ATOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_submission_lays_the_model_out_on_the_mesh(on_the_mesh, mode):
    """Each rank holds half of every weight the rule splits (the model
    axis) or shards (FSDP: every weight but the 0-d ``logit_scale``), and
    the rest whole; the two ranks' halves make the weight."""
    import re

    r0, r1 = on_the_mesh["ranks"][mode]
    split = 0
    for name, shape in r0["shapes"].items():
        n = int(np.prod(shape))
        halved = (re.search(SPLIT, name) is not None if mode == "tp"
                  else len(shape) > 0)
        if not halved:
            assert r0["held"][name] == r1["held"][name] == n, name
            continue
        split += 1
        if mode == "tp" or any(d % 2 == 0 for d in shape):
            assert r0["held"][name] == r1["held"][name] == n // 2, name
        else:      # no dim halves: FSDP2's two chunks of dim 0
            assert r0["held"][name] + r1["held"][name] == n, name
    assert split
