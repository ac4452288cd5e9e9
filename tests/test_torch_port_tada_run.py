"""The port's run list on a TAda config, on the CPU: ``python -m
dist_tpu_torch.run`` on ``configs/projects/tada/k400/tada2d_8x8.yaml`` cut
to a tiny TAda2D (DEPTH 18, narrow widths, 4 frames of 32^2) with
synthetic clips: train (2 fold-epochs of 2 steps, the config's SGD with
Nesterov momentum at a base LR of 0.01, not its 0.48, which sends this
random tiny net's eval-mode scores to NaN; its head dropout of 0.5, a
val eval and a checkpoint after each), the single-view and the
automatic 10 x 3-view test; then a run preempted after one step and
resumed, which equals the uninterrupted one bit for bit (the dropout
masks follow the step count)."""

import os

import numpy as np
import pytest
import torch

from dist_tpu_torch import run
from dist_tpu_torch.utils import checkpoint as cu

TADA = "configs/projects/tada/k400/tada2d_8x8.yaml"
OPTS = ["DATA.SYNTHETIC", "true", "VIDEO.BACKBONE.DEPTH", "18",
        "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
        "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
        "DATA.TRAIN_JITTER_SCALES", "[32, 40]", "DATA.TEST_SCALE", "32",
        "DATA.TEST_CROP_SIZE", "32", "VIDEO.HEAD.NUM_CLASSES", "7",
        "TRAIN.BATCH_SIZE", "2", "TEST.BATCH_SIZE", "6",
        "TRAIN.NUM_SAMPLES_LIMIT", "4", "TEST.NUM_SAMPLES_LIMIT", "2",
        "OPTIMIZER.MAX_EPOCH", "2", "OPTIMIZER.WARMUP_EPOCHS", "1",
        "OPTIMIZER.BASE_LR", "0.01",
        "TRAIN.CHECKPOINT_PERIOD", "1", "TRAIN.EVAL_PERIOD", "1",
        "DATA_LOADER.NUM_WORKERS", "0", "LOG_MODEL_INFO", "false",
        "LOG_CONFIG_INFO", "false"]


def _main(repo_root, out, *opts):
    return run.main(["--cfg", os.path.join(repo_root, TADA), "--device",
                     "cpu", *OPTS, "OUTPUT_DIR", str(out), *opts])


@pytest.fixture(scope="module")
def uninterrupted(repo_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("tada_run")
    return _main(repo_root, out), out


def test_tada_run_list_trains_checkpoints_and_tests(uninterrupted):
    """[train, test, 3 x 10-view test]: 4 steps, a checkpoint after each
    fold-epoch holding the head and every BatchNorm buffer, every test
    view counted once; the test entries load the last checkpoint."""
    (state, single, multi), out = uninterrupted
    assert state.step == 4
    names = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert [n for n in names if n.endswith(".pyth")] == [
        "checkpoint_epoch_00001.pyth", "checkpoint_epoch_00002.pyth"]
    saved = torch.load(os.path.join(out, "checkpoints", names[-2]),
                       weights_only=True)["model_state"]
    sd = state.model.module.state_dict()
    assert sorted(saved) == sorted(sd)
    assert {"head.out.weight", "head.out.bias"} <= set(saved)
    buffers = [k for k, _ in state.model.module.named_buffers()]
    assert buffers and all(k in saved for k in buffers)
    for k, v in sd.items():
        assert torch.equal(saved[k], v.cpu()), k
    for meter, views in ((single, 1), (multi, 30)):
        assert meter.num_clips == views
        assert (meter.clip_count == views).all()
        assert np.isfinite(meter.video_preds).all() and meter.seen.all()


def test_tada_run_resumes_to_the_uninterrupted_run(repo_root, tmp_path,
                                                   uninterrupted):
    (ref, _, _), _ = uninterrupted
    with pytest.raises(SystemExit) as e:
        _main(repo_root, tmp_path, "TRAIN.PREEMPT_AFTER_ITERS", "1",
              "TEST.ENABLE", "false")
    assert e.value.code == 0
    assert cu.get_last_checkpoint(run.load_from_args(
        ["--cfg", os.path.join(repo_root, TADA), *OPTS, "OUTPUT_DIR",
         str(tmp_path)])).endswith("checkpoint_epoch_00000_iter_0000001.pyth")
    resumed, _, _ = _main(repo_root, tmp_path)
    assert resumed.step == ref.step == 4
    got = resumed.model.module.state_dict()
    for k, v in ref.model.module.state_dict().items():
        assert torch.equal(got[k], v), k
