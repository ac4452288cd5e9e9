"""Data-parallel run lists of the port at world 2 on the CPU: two gloo
ranks spawned through the port's own launcher (``parallel/launch.py``, a
``file://`` store), on ``tiny_synth.yaml`` in fp32, mixup and cutmix
off, EMA on (decay 0.9).

- The run list (train 4 steps -> val -> test -> 3-view test) at world 2,
  batch 4 per rank, against the port's one-process list at batch 8, which
  ``test_torch_port_train_run.py`` holds to the JAX run list. The train
  clips' random-resized crop, SSV2 flip and colour jitter draw from
  ``Loader._sample_seed``, which includes the rank (as the JAX loader's
  includes the process), so the two lists would crop other windows of
  the same clips: here both load fixed batches (``FIXED``: the crop is
  the whole frame, no flip, no jitter), and every step's sample indices,
  loss, val errors and test scores are compared.
- The agreed preemption: rank 1 alone sets its flag; both ranks stop at
  one iteration, one checkpoint is written, and the resume equals the
  uninterrupted run bit for bit.
- A world-2 mid-epoch checkpoint resumed at world 1 replays its
  fold-epoch, as the JAX package's loader signature makes it do.
- The test gather: 5 videos split unevenly over the ranks, each view
  counted once, the scores equal to the one-process run's bit for bit.

The world-2 runs share one spawned group (module fixture). The DDP step
itself is ``test_torch_port_ddp.py``'s."""

import os
import shutil

import numpy as np
import pytest
import torch

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.utils import checkpoint as jcu
from dist_tpu_torch.config import load_config
from dist_tpu_torch.parallel import launch
from dist_tpu_torch.utils import checkpoint as cu
from tests import torch_ddp_ranks
from tests.test_torch_port_ddp import OPTS, SPAWN_TIMEOUT_S, TINY

FIXED = ["AUGMENTATION.SSV2_FLIP", "false",
         "DATA.TRAIN_JITTER_SCALES", "[1.0, 1.0]",
         "AUGMENTATION.RATIO", "[1.0, 1.0]", "AUGMENTATION.COLOR_AUG", "false"]
# the run lists: one fold-epoch of two data epochs (4 steps at a global
# batch of 8), 5 test videos (3 views in the second entry)
RUN = OPTS + FIXED + ["TRAIN.NUM_FOLDS", "2", "OPTIMIZER.MAX_EPOCH", "2",
                      "TEST.NUM_SAMPLES_LIMIT", "5", "TEST.BATCH_SIZE", "2",
                      "TRAIN.AUTO_RESUME", "true"]
# Test scores after training, per view, world 2 against world 1: the
# weights differ by what AdamW makes of the all-reduce's other summation
# order (an element whose gradient is near zero steps +-lr either way).
# Read on this geometry and seed (the CPU): 4.0e-7 in both entries; 3
# times that.
TEST_SCORE_ATOL = 1.2e-6


def _argv(repo_root, out, *opts):
    return ["--cfg", os.path.join(repo_root, TINY), "--device", "cpu",
            *RUN, "OUTPUT_DIR", str(out), *opts]


@pytest.fixture(scope="module")
def world2(repo_root, tmp_path_factory):
    """The run lists at world 2, in one spawned group: uninterrupted,
    preempted by rank 1 alone, and resumed."""
    out = tmp_path_factory.mktemp("ddp_run")
    cfg = load_config(os.path.join(repo_root, TINY),
                      RUN + ["TPU.MESH.DATA", "2"], make_output_dir=False)
    per_rank = ["TRAIN.BATCH_SIZE", "4"]
    uninterrupted = [_argv(repo_root, out / "a2", *per_rank)] * 2
    preempt = [_argv(repo_root, out / "b2", *per_rank, "TEST.ENABLE", "false",
                     "TRAIN.PREEMPT_SYNC_PERIOD", "1")]
    preempt.append(preempt[0] + ["TRAIN.PREEMPT_AFTER_ITERS", "2"])
    resume = [preempt[0]] * 2
    lists = launch.launch_task(
        cfg, torch_ddp_ranks.run_lists, (uninterrupted, preempt, resume),
        device="cpu", timeout=SPAWN_TIMEOUT_S)
    return {"out": out,
            **{k: [ranks[i] for ranks in lists] for i, k in enumerate("abc")}}


@pytest.fixture(scope="module")
def world1(repo_root, world2):
    """In this process: the uninterrupted run list at batch 8, and the test
    entries alone on the checkpoint of the uninterrupted world-2 run."""
    out = world2["out"]
    ckpt = out / "a2" / "checkpoints" / "checkpoint_epoch_00002.pyth"
    return torch_ddp_ranks.run_lists(
        [_argv(repo_root, out / "a1", "TRAIN.BATCH_SIZE", "8")],
        [_argv(repo_root, out / "d1", "TRAIN.ENABLE", "false",
               "TEST.CHECKPOINT_FILE_PATH", str(ckpt))])


def test_run_list_at_world_2_matches_one_process(world2, world1):
    """Every step: the union of the ranks' sample indices is the
    one-process list's global batch, the logged loss is the ranks' mean
    (rel 1e-5 of the one-process loss), the top-k errors and LR are
    equal, and the meter counts the global batch. Then the val errors of
    the plain and EMA weights, the final weights (AdamW's travel bound),
    and both test entries' per-video scores within ``TEST_SCORE_ATOL`` a
    view, every video's views counted once."""
    one, two = world1[0], world2["a"]
    assert len(one["steps"]) == len(two[0]["steps"]) == 4
    for k, want in enumerate(one["indices"]):
        got = two[0]["indices"][k] + two[1]["indices"][k]
        assert sorted(got) == sorted(want), k
        assert len(set(two[0]["indices"][k]) & set(two[1]["indices"][k])) == 0
    for rank in two:
        assert rank["steps"] == two[0]["steps"]
    for (g1, g5, gl, glr, gmb), (w1, w5, wl, wlr, wmb) in zip(
            two[0]["steps"], one["steps"]):
        assert gl == pytest.approx(wl, rel=1e-5)
        assert (g1, g5, glr, gmb) == (w1, w5, wlr, wmb)
    assert len(one["val"]) == len(two[0]["val"]) == 2
    for g, w in zip(two[0]["val"], one["val"]):
        for key in ("top1_err", "top5_err"):
            assert g[key] == pytest.approx(w[key], abs=1e-9), key
    # AdamW's travel bound, as test_torch_port_train_run.py's
    b1, b2 = 0.9, 0.999
    travel = sum(lr for *_, lr, _ in one["steps"]) * 10.0   # NEW_NET_LRMULT
    for name, w in one["weights"].items():
        np.testing.assert_array_equal(two[0]["weights"][name],
                                      two[1]["weights"][name], name)
        assert np.abs(two[0]["weights"][name] - w).max() <= (
            2 * (1 - b1) / np.sqrt(1 - b2) * travel), name
    assert [t["num_clips"] for t in two[0]["tests"]] == [1, 3]
    for g, w in zip(two[0]["tests"], one["tests"]):
        np.testing.assert_array_equal(g["clip_count"], g["num_clips"])
        np.testing.assert_array_equal(g["video_labels"], w["video_labels"])
        np.testing.assert_allclose(g["video_preds"], w["video_preds"], rtol=0,
                                   atol=TEST_SCORE_ATOL * g["num_clips"])
    names = sorted(n for n in os.listdir(world2["out"] / "a2" / "checkpoints")
                   if n.endswith(".pyth"))
    assert names == ["checkpoint_epoch_00002.pyth"]


def test_agreed_preemption_and_resume(world2):
    """Rank 1 alone sets its flag after step 2 (``PREEMPT_SYNC_PERIOD
    1``): both ranks leave at the same iteration through
    ``SystemExit(0)``, one mid-epoch checkpoint records the world, and the
    resumed run equals the uninterrupted one bit for bit."""
    b, c, a = world2["b"], world2["c"], world2["a"]
    assert [r["exit"] for r in b] == [0, 0]
    assert [len(r["steps"]) for r in b] == [2, 2]
    mid = "checkpoint_epoch_00000_iter_0000002.pyth"
    ckpts = world2["out"] / "b2" / "checkpoints"
    assert sorted(n for n in os.listdir(ckpts) if n.endswith(".pyth")) == [
        "checkpoint_epoch_00000_iter_0000002.pyth",
        "checkpoint_epoch_00002.pyth"]
    blob = torch.load(ckpts / mid, weights_only=True)
    assert (blob["iter"], blob["step"]) == (2, 2)
    assert list(blob["loader_sig"])[1:3] == [4, 2]
    assert [len(r["steps"]) for r in c] == [2, 2]
    assert [r["step"] for r in c] == [4, 4]
    assert c[0]["steps"] == a[0]["steps"][2:]
    for name, w in a[0]["weights"].items():
        for rank in c:
            np.testing.assert_array_equal(rank["weights"][name], w, name)


def test_world_1_resume_of_a_world_2_checkpoint_replays(repo_root, world2):
    """The mid-epoch checkpoint of two ranks at batch 4 resumed by one
    process at the same global batch, 8: the loader signature [seed,
    per-rank batch, processes, folds, dataset length] differs, so the
    fold-epoch replays from iter 0 (4 steps after the saved 2), as the
    JAX package's signature, equal to the port's at one process, makes it
    do."""
    out = world2["out"] / "e1"
    mid = "checkpoint_epoch_00000_iter_0000002.pyth"
    os.makedirs(out / "checkpoints")
    shutil.copy(world2["out"] / "b2" / "checkpoints" / mid,
                out / "checkpoints" / mid)
    argv = _argv(repo_root, out, "TRAIN.BATCH_SIZE", "8", "TEST.ENABLE",
                 "false")
    (rec,) = torch_ddp_ranks.run_lists([argv])
    assert len(rec["steps"]) == 4 and rec["step"] == 6
    with open(out / "training_log.log") as f:
        assert "loader geometry changed" in f.read()
    path = os.path.join(repo_root, TINY)
    opts = RUN + ["TRAIN.BATCH_SIZE", "8", "TPU.MESH.DATA", "1"]
    want = jcu._loader_signature(jax_load_config(path, opts,
                                                 make_output_dir=False), 16)
    got = cu._loader_signature(load_config(path, opts, make_output_dir=False),
                               16)
    assert got == list(want) and got[2] == 1


def test_test_gather_counts_each_view_once(world2, world1):
    """The world-2 run's test entries against one process's on the same
    checkpoint: 5 videos over two ranks (3 and 2 plus a pad), batch 2 per
    rank against batch 2 in one process; every rank's meter holds every
    view once and the scores of the one-process run bit for bit."""
    one, two = world1[1], world2["a"]
    assert [t["num_clips"] for t in one["tests"]] == [1, 3]
    for rank in two:
        for g, w in zip(rank["tests"], one["tests"]):
            np.testing.assert_array_equal(g["clip_count"], g["num_clips"])
            assert g["video_preds"].shape[0] == 5
            np.testing.assert_array_equal(g["video_labels"], w["video_labels"])
            np.testing.assert_array_equal(g["video_preds"], w["video_preds"])
