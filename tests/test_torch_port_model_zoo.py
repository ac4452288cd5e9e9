"""The port's Model-Zoo harness (``dist_tpu_torch/tools/reproduce_model_zoo.py``)
against the JAX package's (``tools/reproduce_model_zoo.py``, imported by
path and run in this process):

- the ``ZOO`` table, ``_stem`` and the view policy over all eight configs;
- the ``--strict`` preflight's messages and exit codes; the one
  difference: the port reads no Orbax checkpoint, so an Orbax directory
  named after a row's stem is no checkpoint there, and the message says
  so and how to convert it;
- the dry run of all eight rows at the tiny geometry of
  ``tests/test_model_zoo_harness.py``;
- the accept path (no ``--dry-run``) with one synthetic checkpoint and
  ``chip_smoke.py``'s arguments, at that tiny geometry in fp32: the same
  rows and summary, and per-video scores within 1e-4 (float32 sums in
  another order).
"""

import argparse
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import dist_tpu.tasks.test as jax_test
import dist_tpu.utils.misc as jax_misc
from chip_smoke import ZOO_ACCEPT_OPTS
from dist_tpu.config import load_config as jax_load_config
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.tasks import test as port_test
from dist_tpu_torch.tools import reproduce_model_zoo as zoo
from dist_tpu_torch.utils.checkpoint import _ORBAX_TODO
from tests.test_model_zoo_harness import TINY_OPTS

CONFIGS = [row[0] for row in zoo.ZOO]
# fp32, batch 1 and no loader workers beside the tiny geometry
ACCEPT_OPTS = ZOO_ACCEPT_OPTS + TINY_OPTS + [
    "TRAIN.MIXED_PRECISION", "false", "TEST.BATCH_SIZE", "1",
    "DATA_LOADER.NUM_WORKERS", "0"]
FP32_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_zoo(repo_root):
    spec = importlib.util.spec_from_file_location(
        "jax_reproduce_model_zoo",
        os.path.join(repo_root, "tools", "reproduce_model_zoo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _args(**kw):
    ns = dict(ckpt_dir=None, ckpt_map={}, ssv2_root=None, ssv2_anno=None,
              k400_root=None, k400_anno=None)
    ns.update(kw)
    return argparse.Namespace(**ns)


def _lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def _port_main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = zoo.main(argv)
    return code, _lines(out.getvalue())


def _jax_main(jax_zoo, argv, monkeypatch):
    """The JAX harness's exit code and JSON lines; its compile cache is
    left off, so that nothing outlives the call."""
    monkeypatch.setattr(jax_misc, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["reproduce_model_zoo.py"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        jax_zoo.main()
    return e.value.code, _lines(out.getvalue())


def test_zoo_table_matches_jax(jax_zoo):
    assert zoo.ZOO == jax_zoo.ZOO
    assert len(zoo.ZOO) == 8


@pytest.mark.parametrize("override", [True, False])
@pytest.mark.parametrize("config", CONFIGS)
def test_stem_and_view_policy_match_jax(jax_zoo, repo_root, config,
                                        override):
    assert zoo._stem(config) == jax_zoo._stem(config)
    opts = ["TEST.OVERRIDE_MULTI_SCALE_TEST.ENABLE", str(override).lower()]
    path = os.path.join(repo_root, config)
    cfg = load_config(path, opts, make_output_dir=False)
    jcfg = jax_load_config(path, opts, make_output_dir=False)
    zoo._apply_view_policy(cfg)
    jax_zoo._apply_view_policy(jcfg)
    got = (cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS)
    assert got == (jcfg.TEST.NUM_ENSEMBLE_VIEWS, jcfg.TEST.NUM_SPATIAL_CROPS)
    # the configs override to 3 x 1; without it, Kinetics is 10 x 3
    assert got == ((3, 1) if override or "ssv2" in config else (10, 3))


@pytest.mark.parametrize("config", CONFIGS)
def test_strict_preflight_messages_match_jax(jax_zoo, tmp_path, config):
    row = [r for r in zoo.ZOO if r[0] == config]
    stem, family = zoo._stem(config), row[0][1]
    cases = [
        _args(),
        _args(**{f"{family}_root": str(tmp_path / "nowhere"),
                 f"{family}_anno": str(tmp_path / "nowhere"),
                 "ckpt_map": {stem: str(tmp_path / "missing.pyth")}}),
        _args(**{f"{family}_root": str(tmp_path),
                 f"{family}_anno": str(tmp_path),
                 "ckpt_dir": str(tmp_path)}),
    ]
    for args, gaps in zip(cases, (3, 3, 1)):
        got = zoo._preflight_strict(args, row)
        # the JAX message for a row without a checkpoint also names the
        # Orbax directory it would take
        want = [m.replace(f" or an Orbax dir named {stem}", "")
                for m in jax_zoo._preflight_strict(args, row)]
        assert got == want and len(got) == gaps
    assert zoo._preflight_strict(cases[0], row)[-1] == (
        f"{config}: no checkpoint named {stem}[.pyth/.pt/.pth] under "
        "--ckpt-dir, and no --ckpt override")
    # a checkpoint file in --ckpt-dir is found by both
    (tmp_path / f"{stem}.pyth").write_bytes(b"")
    assert zoo._preflight_strict(cases[2], row) == \
        jax_zoo._preflight_strict(cases[2], row) == []


@pytest.mark.parametrize("config", CONFIGS)
def test_orbax_dir_is_no_checkpoint_and_says_why(jax_zoo, tmp_path, config):
    """An Orbax directory named after the stem: the JAX harness takes it,
    the port names it and says how to convert it."""
    row = [r for r in zoo.ZOO if r[0] == config]
    stem, family = zoo._stem(config), row[0][1]
    orbax = tmp_path / stem
    orbax.mkdir()
    args = _args(**{f"{family}_root": str(tmp_path),
                    f"{family}_anno": str(tmp_path),
                    "ckpt_dir": str(tmp_path)})
    assert jax_zoo._preflight_strict(args, row) == []
    assert zoo._preflight_strict(args, row) == [
        f"{config}: {orbax}: {_ORBAX_TODO}"]
    args.dry_run, args.opts, args.output_dir = False, [], str(tmp_path)
    with pytest.raises(FileNotFoundError, match="state_dict_from_jax"):
        zoo.row_config(args, config, family)


def test_strict_exit_codes(tmp_path):
    code, lines = _port_main(["--strict", "--configs", "ssv2",
                              "--output-dir", str(tmp_path)])
    assert code == 2
    missing = [ln["missing"] for ln in lines if "missing" in ln
               and "summary" not in ln]
    assert len(missing) == 12 and any("ssv2_vit-l14-32+64f" in m
                                      for m in missing)
    assert "UNPROVEN" in lines[-1]["error"]
    assert not any("config" in ln for ln in lines)
    code, lines = _port_main(["--strict", "--dry-run", "--configs", "ssv2",
                              "--output-dir", str(tmp_path)])
    assert code == 2 and "proves the harness" in lines[-1]["error"]
    # every row, as chip_smoke.py's zoo phase asks
    code, lines = _port_main(["--strict", "--output-dir", str(tmp_path)])
    assert code == 2 and lines[-1]["missing"] == 24


def test_entry_points_need_a_card_or_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _port_main(["--dry-run", "--configs", "ssv2/vit-b16-8+16f",
                    "--output-dir", str(tmp_path), "--opts", *TINY_OPTS])
    with pytest.raises(ValueError, match="no zoo entry"):
        _port_main(["--configs", "ucf101"])


def test_dry_run_of_every_row(tmp_path):
    """``--dry-run`` over the eight rows at the tiny geometry: each row
    with the policy's views capped at 2 x 1, the published numbers, and
    a summary that proves nothing."""
    code, lines = _port_main(["--dry-run", "--dry-run-samples", "2",
                              "--device", "cpu", "--output-dir",
                              str(tmp_path), "--opts", *TINY_OPTS])
    assert code == 0
    rows = [ln for ln in lines if "config" in ln]
    assert [r["config"] for r in rows] == CONFIGS
    for r, (_, _, acc1, acc5) in zip(rows, zoo.ZOO):
        assert r["dry_run"] and r["pass"] and r["views"] == "2x1"
        assert (r["expected_top1"], r["expected_top5"]) == (acc1, acc5)
    assert lines[-1] == {"summary": "model_zoo_repro", "models": 8,
                         "failures": 0, "tolerance": 0.3, "proof": False}


def _recording(module, monkeypatch):
    meters = []

    class Recorded(module.TestMeter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            meters.append(self)

    monkeypatch.setattr(module, "TestMeter", Recorded)
    return meters


def test_accept_path_matches_jax(jax_zoo, repo_root, tmp_path, monkeypatch):
    """One synthetic checkpoint through both harnesses without
    ``--dry-run``, with chip_smoke.py's accept-path arguments at the tiny
    geometry: the same rows (a miss of the published number, exit 1) and
    summary (``"proof": true``), and per-video scores within 1e-4."""
    config = CONFIGS[0]
    cfg = load_config(os.path.join(repo_root, config), ACCEPT_OPTS,
                      make_output_dir=False)
    ckpt = str(tmp_path / "weights.pyth")
    torch.save({"model_state": build_model(cfg, device="cpu", seed=3)
                .module.state_dict()}, ckpt)
    empty = tmp_path / "empty"
    empty.mkdir()
    argv = ["--configs", "ssv2/vit-b16-8+16f",
            "--ckpt", f"{zoo._stem(config)}={ckpt}",
            "--ssv2-root", str(empty), "--ssv2-anno", str(empty)]
    jax_meters = _recording(jax_test, monkeypatch)
    port_meters = _recording(port_test, monkeypatch)
    jcode, jlines = _jax_main(jax_zoo, argv + [
        "--output-dir", str(tmp_path / "jax"), "--opts", *ACCEPT_OPTS],
        monkeypatch)
    code, lines = _port_main(argv + [
        "--device", "cpu", "--output-dir", str(tmp_path / "port"),
        "--opts", *ACCEPT_OPTS])
    assert (code, jcode) == (1, 1)
    assert lines == jlines
    assert lines[0]["views"] == "3x1" and not lines[0]["dry_run"]
    assert lines[-1]["proof"] and lines[-1]["failures"] == 1
    (got,), (want,) = port_meters, jax_meters
    assert got.video_preds.shape == (4, 12)
    np.testing.assert_allclose(got.video_preds, want.video_preds,
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_array_equal(got.clip_count, 3)


def test_card_tests_tiny_opts_are_the_jax_harness_tests():
    """The card test's copy of the tiny geometry (its file imports no other
    test module) is this file's."""
    from tests.test_torch_port_cuda import ZOO_TINY_OPTS

    assert ZOO_TINY_OPTS == TINY_OPTS
