"""SSL pretraining's entry path in the port, on the CPU:

- ``python -m dist_tpu_torch.run`` on the SimCLR S3D-G config (tiny
  geometry, synthetic views, the device augmentation and LARS as
  configured) runs only the train entry (``TEST.ENABLE false``,
  ``EVAL_PERIOD 0``); a run of 2 epochs of 2 steps preempted after 3
  steps (a mid-epoch checkpoint) and resumed ends with the weights, the
  running stats and the LARS momentum buffers of an uninterrupted run,
  bit for bit, and its checkpoint holds the head, its running stats and
  the LARS state;
- all 16 pretrain configs (``configs/projects/hico/simclr_*.yaml``,
  ``hico/pt-*/``, ``hico++/hico++_*.yaml``, ``hico++/pt-*/``) build in
  the port: the model at full width on the meta device with its
  contrastive head, LARS over it, the head on the CPU and the
  configured loss on its output for 2 videos, finite;
- every ``TRAIN.ONLY_LINEAR`` recipe of ``configs/projects`` freezes the
  backbone and trains the head, as the JAX package's
  ``tests/test_ssl.py::test_all_project_configs_load_and_linear_probe_labels``
  checks for its labels."""

import glob
import os

import pytest
import torch
import torch.nn as nn

from dist_tpu_torch import run
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base import models as pm
from dist_tpu_torch.models.base.blocks import init_weights
from dist_tpu_torch.optim import optimizer as popt
from dist_tpu_torch.optim.losses import calculate_loss

SIMCLR = "configs/projects/hico/simclr_k400_s3dg.yaml"
RUN_OPTS = ["DATA.SYNTHETIC", "true", "DATA.NUM_INPUT_FRAMES", "8",
            "DATA.TRAIN_CROP_SIZE", "32", "DATA.TEST_SCALE", "32",
            "DATA.TEST_CROP_SIZE", "32", "TRAIN.BATCH_SIZE", "2",
            "TRAIN.NUM_SAMPLES_LIMIT", "4", "TRAIN.NUM_FOLDS", "1",
            "TRAIN.CHECKPOINT_PERIOD", "1", "OPTIMIZER.WARMUP_EPOCHS", "1",
            "PRETRAIN.CONTRASTIVE.HEAD_MID_DIM", "32",
            "PRETRAIN.CONTRASTIVE.HEAD_OUT_DIM", "16",
            "DATA_LOADER.NUM_WORKERS", "2", "LOG_PERIOD", "1",
            "LOG_MODEL_INFO", "false", "LOG_CONFIG_INFO", "false"]


def _run(repo_root, out, *opts):
    argv = (["--cfg", os.path.join(repo_root, SIMCLR), "--device", "cpu"]
            + RUN_OPTS + list(opts) + ["OPTIMIZER.MAX_EPOCH", "2",
                                       "OUTPUT_DIR", str(out)])
    try:
        results = run.main(argv)
    except SystemExit as e:
        return e
    assert len(results) == 1          # the train entry alone
    return results[0]


@pytest.fixture
def few_threads():
    """Two intra-op threads for the test: the suite runs in several
    worker processes at once, and S3D-G's CPU convolutions on every core
    in each of them oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_pretrain_run_list_resumes_lars_bit_for_bit(repo_root, tmp_path,
                                                     few_threads):
    whole = _run(repo_root, tmp_path / "whole")
    cut = _run(repo_root, tmp_path / "cut", "TRAIN.PREEMPT_AFTER_ITERS", "3")
    assert isinstance(cut, SystemExit) and cut.code == 0
    names = sorted(n for n in os.listdir(tmp_path / "cut" / "checkpoints")
                   if n.endswith(".pyth"))
    assert "_iter_" in names[-1], names
    ckpt = torch.load(tmp_path / "cut" / "checkpoints" / names[-1],
                      weights_only=False)
    assert any(k.startswith("head.mlp.linear_a_bn.running")
               for k in ckpt["model_state"])
    buffers = [s["momentum_buffer"] for s in
               ckpt["optimizer_state"]["state"].values()]
    assert buffers and all(torch.is_tensor(b) for b in buffers)
    resumed = _run(repo_root, tmp_path / "cut")
    assert whole.step == resumed.step == 4
    assert isinstance(resumed.optimizer, popt.LARS)
    want = whole.model.module.state_dict()
    for k, v in resumed.model.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    for p, q in zip(resumed.model.module.parameters(),
                    whole.model.module.parameters()):
        assert torch.equal(resumed.optimizer.state[p]["momentum_buffer"],
                           whole.optimizer.state[q]["momentum_buffer"])


def pretrain_configs(repo_root):
    pats = ["configs/projects/hico/simclr_*.yaml",
            "configs/projects/hico/pt-*/*.yaml",
            "configs/projects/hico++/hico++_*.yaml",
            "configs/projects/hico++/pt-*/*.yaml"]
    return sorted(p for pat in pats
                  for p in glob.glob(os.path.join(repo_root, pat)))


def test_all_pretrain_configs_build_in_the_port(repo_root):
    paths = pretrain_configs(repo_root)
    assert len(paths) == 16, paths
    heads = set()
    for path in paths:
        cfg = load_config(path, make_output_dir=False)
        name = os.path.relpath(path, repo_root)
        assert cfg.PRETRAIN.ENABLE and cfg.AUGMENTATION.USE_GPU, name
        assert [task.__name__ for _, task in run._prepare_data(cfg)] == [
            "train"], name
        module = pm.build_backbone_on_meta(cfg)
        assert isinstance(module, pm.BaseVideoModel), name
        heads.add(type(module.head).__name__)
        optimizer, _ = popt.construct_optimizer(cfg, module, 10)
        assert isinstance(optimizer, popt.LARS), name
        assert {g["group"] for g in optimizer.param_groups} <= {
            popt.TRAINABLE, popt.NO_WD, popt.BN}, name
        dim = next(m for m in module.head.modules()
                   if isinstance(m, nn.Linear)).in_features
        head = pm.build_head(cfg, dim)
        gen = torch.Generator().manual_seed(132)
        init_weights(head, gen)
        n = int(cfg.PRETRAIN.NUM_CLIPS_PER_VIDEO)
        feats = torch.randn(2 * n, dim, generator=gen)
        preds, logits = head.train()(feats)
        loss, parts = calculate_loss(cfg, preds, logits, {
            "self-supervised": {"contrastive": torch.arange(n).repeat(2, 1)}})
        assert torch.isfinite(loss) and parts, name
    assert heads == {"ContrastiveHead", "ContrastiveHeadTopicPred",
                     "ContrastiveHeadTopicPredPlusPlus"}


class _Probe(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = nn.ModuleDict({"conv": nn.Linear(4, 8)})
        self.head = nn.ModuleDict({"linear": nn.Linear(8, 5)})


def test_linear_probe_recipes_freeze_the_backbone(repo_root):
    paths = sorted(glob.glob(os.path.join(
        repo_root, "configs/projects/**/*.yaml"), recursive=True))
    assert len(paths) >= 60
    linear = [cfg for cfg in (load_config(p, make_output_dir=False)
                              for p in paths)
              if cfg.TRAIN.get("ONLY_LINEAR")]
    assert linear
    for cfg in linear:
        labels = popt.param_labels(cfg, _Probe())
        assert labels["backbone.conv.weight"] == popt.FROZEN
        assert labels["head.linear.weight"] != popt.FROZEN
