"""The gate of the port's test run list: ``python -m dist_tpu_torch.run``
(test, then the automatic multi-view test) against the JAX package's
``runs/run.py::_prepare_data`` run list on ``tiny_synth.yaml``, both
pointed at one ``.pyth`` made by the port from a seed.

- fp32: per-video ensembled scores within 1e-4 (float32 sums in another
  order), the same labels and clip counts, and the same top-1 wherever
  its margin over the second exceeds 1e-3.
- bf16 (the config's policy), the port's TemporalNet fused as on the
  card, against the JAX package's fp32 scores: within
  ``RUN_LIST_BF16_LIMIT`` per view.

The JAX run list runs once for the file (~50 s). Beside it: the options
the test task refuses. The run list's other checks are
``test_torch_port_test_entries.py``'s."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import dist_tpu.tasks.test as jax_test
from dist_tpu.config import config as jax_config
from dist_tpu_torch import run
from dist_tpu_torch.config import config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.tasks import test as port_test
from tests.test_torch_port_cuda import RUN_LIST_BF16_LIMIT

TINY = "configs/projects/dist/test/tiny_synth.yaml"
FP32_ATOL = 1e-4
TOP1_MARGIN = 1e-3


def _jax_run_module(repo_root):
    spec = importlib.util.spec_from_file_location(
        "jax_run", os.path.join(repo_root, "runs", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _opts(out, ckpt, precision):
    return ["TRAIN.ENABLE", "false", "TRAIN.MIXED_PRECISION", precision,
            "OUTPUT_DIR", out, "TEST.CHECKPOINT_FILE_PATH", ckpt]


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
    """{"jax": [meters], "fp32": [meters], "bf16": [meters]}, one meter
    per entry of the run list (single view, then 3 views)."""
    out = str(tmp_path_factory.mktemp("run_list"))
    cfg_path = os.path.join(repo_root, TINY)
    ckpt = os.path.join(out, "weights.pyth")
    cfg = config.load_config(cfg_path, ["TRAIN.MIXED_PRECISION", "false"],
                             make_output_dir=False)
    torch.save(build_model(cfg, device="cpu", seed=0).module.state_dict(),
               ckpt)

    jax_meters = []

    class Recorded(jax_test.TestMeter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            jax_meters.append(self)

    jax_run = _jax_run_module(repo_root)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, "TestMeter", Recorded)
        jcfg = jax_config.load_config(cfg_path, _opts(out, ckpt, "false"))
        for run_cfg, func in jax_run._prepare_data(jcfg):
            func(run_cfg)
    argv = ["--cfg", cfg_path, "--device", "cpu"]
    return {"jax": jax_meters,
            "fp32": run.main(argv + _opts(out, ckpt, "false")),
            "bf16": run.main(argv + _opts(out, ckpt, "true")
                             + ["TPU.FUSED_TEMPORAL_NET", "true"]),
            "out": out}


@pytest.mark.parametrize("entry", [0, 1])
def test_fp32_run_list_matches_jax(runs, entry):
    got, want = runs["fp32"][entry], runs["jax"][entry]
    assert got.num_clips == want.num_clips == (1, 3)[entry]
    np.testing.assert_allclose(got.video_preds, want.video_preds,
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_array_equal(got.clip_count, want.clip_count)
    np.testing.assert_array_equal(got.clip_count, got.num_clips)
    top2 = np.sort(want.video_preds, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > TOP1_MARGIN
    np.testing.assert_array_equal(got.video_preds.argmax(1)[clear],
                                  want.video_preds.argmax(1)[clear])


@pytest.mark.parametrize("entry", [0, 1])
def test_bf16_run_list_within_its_limit(runs, entry):
    got, want = runs["bf16"][entry], runs["jax"][entry]
    err = np.abs(got.video_preds - want.video_preds).max() / got.num_clips
    assert err <= RUN_LIST_BF16_LIMIT, err
    np.testing.assert_array_equal(got.clip_count, got.num_clips)


def test_run_list_logs_and_times_each_entry(runs):
    for meter, batches in zip(runs["fp32"], (8, 24)):
        t = meter.timing
        assert t["batches"] == batches
        assert 0 <= t["loader_wait_s"] <= t["loop_s"]
        assert set(meter.stats) == {"_type", "top1_acc", "top5_acc"}
    logs = os.listdir(runs["out"])
    assert "val.log" in logs and "val_3clipsx1crops.log" in logs


@pytest.mark.parametrize("opts,world,error,match", [
    (["TPU.SHARD_FRAMES", "true"], 2, ValueError, "SHARD_FRAMES")])
def test_unported_test_options_are_refused(repo_root, monkeypatch, opts,
                                           world, error, match):
    """``TPU.SHARD_FRAMES`` is one process over its local devices and
    refuses a group of more than one rank, as the JAX package asserts a
    single process (it runs in one: ``test_torch_port_local_devices.py``).
    Visualization is ported: ``test_torch_port_visualization.py``."""
    cfg = config.load_config(os.path.join(repo_root, TINY), opts,
                             make_output_dir=False)
    if world > 1:
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size",
                            lambda group=None: world)
    with pytest.raises(error, match=match):
        port_test.test(cfg, device="cpu")
