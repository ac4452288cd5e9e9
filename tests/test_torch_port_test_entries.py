"""The port's test entries beside the run-list gate of
``test_torch_port_test_task.py`` (apart from it so that the suite's
workers share the two): the run list's view policy against the JAX
package's for other datasets and with training first, the submission
entry, the argument parser, the entry points' need of a card, the eval
step's metrics and EMA weights, and the bf16 readings tool behind
``RUN_LIST_BF16_LIMIT``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dist_tpu.config import config as jax_config
from dist_tpu_torch import run
from dist_tpu_torch.config import config
from dist_tpu_torch.data.base_dataset import resolve_label_texts
from dist_tpu_torch.data.builder import build_loader
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.tasks import test as port_test
from dist_tpu_torch.tasks import train as port_train
from dist_tpu_torch.tasks.state import (
    TrainState,
    compute_text_features,
    make_eval_step,
)
from tests.test_torch_port_cuda import RUN_LIST_BF16_LIMIT
from tests.test_torch_port_test_task import TINY, _jax_run_module


@pytest.mark.parametrize("opts", [
    [], ["TEST.DATASET", "kinetics400"], ["TEST.DATASET", "epickitchen100"],
    ["TEST.DATASET", "imagenet"], ["TEST.AUTOMATIC_MULTI_SCALE_TEST", "false"],
    ["TEST.OVERRIDE_MULTI_SCALE_TEST.ENABLE", "true",
     "TEST.OVERRIDE_MULTI_SCALE_TEST.NUM_ENSEMBLE_VIEWS", "2",
     "TEST.OVERRIDE_MULTI_SCALE_TEST.NUM_SPATIAL_CROPS", "3"],
    ["TEST.ENABLE", "false"], ["TRAIN.ENABLE", "true"],
    ["TRAIN.ENABLE", "true", "TEST.ENABLE", "false"]])
def test_run_list_views_match_jax(repo_root, opts):
    """The run list's entries, their order and their configs; with
    ``TRAIN.ENABLE true`` training comes first."""
    path = os.path.join(repo_root, TINY)
    opts = ["TRAIN.ENABLE", "false"] + opts
    got = run._prepare_data(config.load_config(path, opts,
                                               make_output_dir=False))
    want = _jax_run_module(repo_root)._prepare_data(
        jax_config.load_config(path, opts, make_output_dir=False))
    assert len(got) == len(want)
    ports = {"train": port_train.train, "test": port_test.test}
    for (g, gf), (w, wf) in zip(got, want):
        assert gf is ports[wf.__name__]
        assert g.cfg_dict == w.cfg_dict


def test_training_and_submission_are_refused(repo_root):
    """Neither is refused any longer: training's run list is
    ``test_run_list_views_match_jax``'s ``TRAIN.ENABLE`` cases, and with
    ``SUBMISSION.ENABLE`` the submission test (ROADMAP.md queue A, item
    5) comes last at 10 x 3 views, as in the JAX run list."""
    from dist_tpu_torch.tasks.submission import submission_test

    path = os.path.join(repo_root, TINY)
    opts = ["TRAIN.ENABLE", "false", "SUBMISSION.ENABLE", "true"]
    got = run._prepare_data(config.load_config(path, opts,
                                               make_output_dir=False))
    want = _jax_run_module(repo_root)._prepare_data(
        jax_config.load_config(path, opts, make_output_dir=False))
    assert [f.__name__ for _, f in got] == [f.__name__ for _, f in want]
    assert got[-1][1] is submission_test
    for (g, _), (w, _) in zip(got, want):
        assert g.cfg_dict == w.cfg_dict
    assert (got[-1][0].TEST.NUM_ENSEMBLE_VIEWS,
            got[-1][0].TEST.NUM_SPATIAL_CROPS) == (10, 3)


def test_parse_args_matches_jax(repo_root):
    argv = ["--cfg", os.path.join(repo_root, TINY), "TEST.BATCH_SIZE", "3"]
    got = config.load_from_args(argv)
    want = jax_config.load_from_args(argv)
    assert got.cfg_dict == want.cfg_dict and got.args.device is None
    got = config.load_from_args(["--device", "cpu"] + argv)
    assert got.args.device == "cpu" and got.TEST.BATCH_SIZE == 3
    with pytest.raises(ValueError, match="--cfg"):
        config.load_from_args([])


def test_entry_points_need_a_card_unless_told(repo_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(repo_root, TINY)
    cfg = config.load_config(path, ["TRAIN.ENABLE", "false"],
                             make_output_dir=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_test.test(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_loader(cfg, "test")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--cfg", path, "TRAIN.ENABLE", "false"])


def test_cli_without_a_card_fails(repo_root, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "-m", "dist_tpu_torch.run", "--cfg",
         os.path.join(repo_root, TINY), "TRAIN.ENABLE", "false",
         "OUTPUT_DIR", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=repo_root)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr


def test_eval_step_metrics_over_the_mask_and_ema(repo_root):
    cfg = config.load_config(os.path.join(repo_root, TINY),
                             ["TRAIN.MIXED_PRECISION", "false"],
                             make_output_dir=False)
    model = build_model(cfg, device="cpu", seed=0)
    other = build_model(cfg, device="cpu", seed=1)
    rng = np.random.default_rng(0)
    _, tokens = resolve_label_texts(cfg, 12)
    batch = {"video": torch.from_numpy(rng.integers(
                 0, 256, (4, 4, 64, 64, 3), dtype=np.uint8)),
             "text_features": compute_text_features(model, tokens),
             "labels": torch.tensor([0, 5, 7, 11]),
             "mask": torch.tensor([1.0, 1.0, 1.0, 0.0])}
    out = make_eval_step(model, cfg)(batch)
    preds = out["preds"].numpy()
    order = np.argsort(-preds, axis=1)
    keep = batch["mask"].numpy() > 0
    labels = batch["labels"].numpy()
    for k, key in ((1, "top1_err"), (5, "top5_err")):
        hit = (order[:, :k] == labels[:, None]).any(1)[keep]
        assert float(out[key]) == pytest.approx(100 * (1 - hit.mean()))
    assert float(out["num_valid"]) == 3
    served = {k: batch[k] for k in ("video", "text_features")}
    assert set(make_eval_step(model, cfg)(served)) == {"preds"}
    # the EMA copy stands in for the module's weights
    state = TrainState(model=model, optimizer=None,
                       ema=other.module.state_dict())
    ema_preds = make_eval_step(model, cfg, use_ema=True)(batch, state)["preds"]
    torch.testing.assert_close(ema_preds, make_eval_step(other, cfg)(
        batch)["preds"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="EMA"):
        make_eval_step(model, cfg, use_ema=True)(batch)


@pytest.fixture
def few_threads():
    """Two intra-op threads for the port while the test runs: the suite
    runs in several worker processes at once, and every core in each of
    them would oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_run_list_error_readings_on_the_cpu(repo_root, few_threads):
    """The readings tool behind ``RUN_LIST_BF16_LIMIT``, one seed on the
    CPU: one reading per entry of the run list, inside the limit."""
    from dist_tpu_torch.tools import run_list_errors

    recs = run_list_errors.readings("cpu", 1, repo_root)
    assert [r["views"] for r in recs] == [1, 3]
    assert all(0 < r["max_abs_diff_per_view"] <= RUN_LIST_BF16_LIMIT
               for r in recs)
