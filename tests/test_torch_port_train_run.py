"""The gate of the port's train run: ``python -m dist_tpu_torch.run`` with
``TRAIN.ENABLE true`` (train -> val -> test -> 3-view test) against the
JAX package's ``runs/run.py::_prepare_data`` run list on
``tiny_synth.yaml``, two fold-epochs of two steps, fp32, mixup and cutmix
off, EMA on (decay 0.9).

Both start from one ``.pyth`` made by the port from a seed, given as
``TRAIN.CHECKPOINT_FILE_PATH`` (the fine-tune branch on both sides) and as
the pretrained weights: the JAX fine-tune init leaves its EMA copy at the
weights it had before the load, the port's restarts it from the loaded
ones, and with the init equal to the file both EMA copies start from it.
The JAX package's global batch on 8 virtual devices is ``BATCH_SIZE x
8``, so the port runs at batch 8. The port's own loader makes the
batches: its resize equals OpenCV's, which the JAX package calls, bit for
bit (``test_torch_port_resize.py``), so both packages train on the same
batches.

Held to the JAX run list: every step's loss (rel 1e-5), top-1 error and
LR; the val top-1/top-5 errors of every eval epoch, plain and EMA; the
checkpoint names with their epoch and step; the final weights (the AdamW
travel tolerance of ``test_torch_port_train.py``); and the per-video
scores of both test entries, which load the last checkpoint, within
``TEST_SCORE_ATOL``. The port's list in bf16 with the fused TemporalNet
is held to its fp32 list within ``TRAIN_RUN_BF16_LOSS_RTOL`` (per step;
read 1.4e-4 to 1.01e-3) and ``RUN_LIST_BF16_LIMIT`` (the test scores;
read 6.3e-3 per view).

The JAX run list runs once for the module (~2 min on one CPU worker)."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import dist_tpu.tasks.test as jax_test
import dist_tpu.tasks.train as jax_train
from dist_tpu.config import config as jax_config
from dist_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dist_tpu_torch import run
from dist_tpu_torch.config import config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.models.clip.convert import state_dict_from_jax
from dist_tpu_torch.optim.optimizer import FROZEN, param_labels
from dist_tpu_torch.tasks import test as port_test
from dist_tpu_torch.tasks import train as port_train
from tests.test_torch_port_cuda import (
    RUN_LIST_BF16_LIMIT,
    TRAIN_RUN_BF16_LOSS_RTOL,
)

TINY = "configs/projects/dist/test/tiny_synth.yaml"
OPTS = ["TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE", "false",
        "AUGMENTATION.CUTMIX.ENABLE", "false", "MODEL.EMA.ENABLE", "true",
        "MODEL.EMA.DECAY", "0.9", "OPTIMIZER.MAX_EPOCH", "2"]
PORT_BATCH = ["TRAIN.BATCH_SIZE", "8", "TEST.BATCH_SIZE", "8"]
# Test scores after training, per view: the weights differ by what AdamW
# makes of float noise (an element whose gradient is near zero steps +-lr
# either way), which moves a view's softmax scores. Read on this geometry
# and seed (the CPU): 8.6e-7 in both entries; 3 times that.
TEST_SCORE_ATOL = 2.6e-6


def _jax_run_module(repo_root):
    spec = importlib.util.spec_from_file_location(
        "jax_run", os.path.join(repo_root, "runs", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Records:
    """Meter subclasses of one package that keep what the run fed them:
    each train step's (top1, top5, loss, lr), each val epoch's stats and
    each test meter."""

    def __init__(self, train_mod, test_mod):
        self.steps, self.val, self.tests = [], [], []
        rec = self

        class Train(train_mod.TrainMeter):
            def update_stats(self, top1, top5, loss, lr, mb):
                rec.steps.append((top1, top5, loss, lr))
                super().update_stats(top1, top5, loss, lr, mb)

        class Val(train_mod.ValMeter):
            def log_epoch_stats(self, cur_epoch):
                stats = super().log_epoch_stats(cur_epoch)
                rec.val.append(stats)
                return stats

        class Test(test_mod.TestMeter):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                rec.tests.append(self)

        self.patches = [(train_mod, "TrainMeter", Train),
                        (train_mod, "ValMeter", Val),
                        (test_mod, "TestMeter", Test)]


def _ckpts(out, read):
    d = os.path.join(out, "checkpoints")
    names = sorted(n for n in os.listdir(d) if n.startswith("checkpoint_")
                   and not n.endswith(".config.yaml"))
    return {n: read(os.path.join(d, n)) for n in names}


def _port_ckpt(path):
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return int(blob["epoch"]), int(blob["step"])


def _jax_ckpt(path):
    blob = jax_load_checkpoint(path)
    return int(blob["epoch"]), int(blob["step"])


def _port_list(repo_root, out, ckpt, *opts):
    argv = ["--cfg", os.path.join(repo_root, TINY), "--device", "cpu", *OPTS,
            *PORT_BATCH, "TRAIN.CHECKPOINT_FILE_PATH", ckpt,
            "VIDEO.BACKBONE.LOCAL_PRETRAIN_WEIGHT_PATH", ckpt,
            "OUTPUT_DIR", out, *opts]
    rec = _Records(port_train, port_test)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, cls in rec.patches:
            mp.setattr(mod, name, cls)
        rec.results = run.main(argv)
    rec.ckpts = _ckpts(out, _port_ckpt)
    return rec


@pytest.fixture(scope="module")
def few_threads():
    """Two intra-op threads for the port's side while the module's
    fixture runs: the suite runs in several worker processes at once, and
    every core in each of them would oversubscribe the host many times
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(repo_root, tmp_path_factory, few_threads):
    out = str(tmp_path_factory.mktemp("train_run"))
    cfg_path = os.path.join(repo_root, TINY)
    ckpt = os.path.join(out, "weights.pyth")
    cfg = config.load_config(cfg_path, OPTS, make_output_dir=False)
    torch.save(build_model(cfg, device="cpu", seed=0).module.state_dict(),
               ckpt)

    jax_out = os.path.join(out, "jax")
    jax = _Records(jax_train, jax_test)
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, cls in jax.patches:
            mp.setattr(mod, name, cls)
        jcfg = jax_config.load_config(cfg_path, OPTS + [
            "TRAIN.CHECKPOINT_FILE_PATH", ckpt,
            "VIDEO.BACKBONE.LOCAL_PRETRAIN_WEIGHT_PATH", ckpt,
            "OUTPUT_DIR", jax_out])
        jax.results = [func(run_cfg) for run_cfg, func in
                       _jax_run_module(repo_root)._prepare_data(jcfg)]
    jax.ckpts = _ckpts(jax_out, _jax_ckpt)
    return {"jax": jax,
            "fp32": _port_list(repo_root, os.path.join(out, "fp32"), ckpt),
            "bf16": _port_list(repo_root, os.path.join(out, "bf16"), ckpt,
                               "TRAIN.MIXED_PRECISION", "true",
                               "TPU.FUSED_TEMPORAL_NET", "true"),
            "cfg": cfg}


def test_steps_match_jax(runs):
    got, want = runs["fp32"].steps, runs["jax"].steps
    assert len(got) == len(want) == 4
    for (g1, g5, gl, glr), (w1, w5, wl, wlr) in zip(got, want):
        assert gl == pytest.approx(wl, rel=1e-5)
        assert (g1, g5) == (w1, w5)
        assert glr == pytest.approx(wlr, rel=1e-6)


def test_val_errors_match_jax(runs):
    """Two eval epochs, each the plain weights then the EMA's."""
    got, want = runs["fp32"].val, runs["jax"].val
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key in ("top1_err", "top5_err", "min_top1_err", "min_top5_err"):
            assert g[key] == pytest.approx(w[key], abs=1e-9), key
        assert g["epoch"] == w["epoch"]


def test_checkpoints_match_jax(runs):
    got, want = runs["fp32"].ckpts, runs["jax"].ckpts
    assert {k[:-len(".pyth")]: v for k, v in got.items()} == want
    assert list(want.values()) == [(1, 2), (2, 4)]


def test_final_weights_match_jax(runs):
    """AdamW steps each element about +-lr * NEW_NET_LRMULT whatever its
    gradient's size, so an element whose gradient is float noise may step
    either way: every weight within the most AdamW can move an element,
    2 * (1 - beta1) / sqrt(1 - beta2) * sum_k lr_k * mult; frozen ones bit
    for bit."""
    cfg = runs["cfg"]
    state = runs["fp32"].results[0]
    want = state_dict_from_jax(jax_dev_get(runs["jax"].results[0]))
    mult = float(cfg.OPTIMIZER.NEW_NET_LRMULT)
    travel = sum(lr for *_, lr in runs["jax"].steps) * mult
    b1, b2 = cfg.OPTIMIZER.BETAS
    bound = 2 * (1 - b1) / np.sqrt(1 - b2) * travel
    labels = param_labels(cfg, state.model.module)
    start = build_model(cfg, device="cpu", seed=0).module.state_dict()
    moved = 0
    for name, p in state.model.module.named_parameters():
        got = p.detach().numpy()
        if labels[name] == FROZEN:
            np.testing.assert_array_equal(got, start[name].numpy(), name)
            np.testing.assert_array_equal(got, want[name], name)
            continue
        assert np.abs(got - want[name]).max() <= bound, name
        moved += int(not np.array_equal(got, start[name].numpy()))
    assert moved > 0


def jax_dev_get(state):
    import jax

    return jax.device_get(state.variables)["params"]


@pytest.mark.parametrize("entry", [0, 1])
def test_test_entries_match_jax(runs, entry):
    """Both test entries load the last checkpoint that training wrote."""
    got, want = runs["fp32"].tests[entry], runs["jax"].tests[entry]
    assert got.num_clips == want.num_clips == (1, 3)[entry]
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_array_equal(got.clip_count, got.num_clips)
    np.testing.assert_allclose(got.video_preds, want.video_preds,
                               atol=TEST_SCORE_ATOL * got.num_clips, rtol=0)


def test_bf16_list_within_its_limits(runs):
    """The port's list in bf16 with the fused TemporalNet (K2 and K3's
    plain versions here) against its fp32 list."""
    got, want = runs["bf16"], runs["fp32"]
    assert len(got.steps) == len(want.steps)
    for (*_, gl, glr), (*_, wl, wlr) in zip(got.steps, want.steps):
        assert gl == pytest.approx(wl, rel=TRAIN_RUN_BF16_LOSS_RTOL)
        assert glr == wlr
    assert got.ckpts == want.ckpts
    for g, w in zip(got.tests, want.tests):
        err = np.abs(g.video_preds - w.video_preds).max() / g.num_clips
        assert err <= RUN_LIST_BF16_LIMIT, err
