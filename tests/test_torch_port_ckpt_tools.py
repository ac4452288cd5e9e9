"""The port's checkpoint tools against the JAX package's, on
``tests/synth_ckpt.py`` weights at the tiny geometry of ``tiny_synth.yaml``:

- ``convert_checkpoint``: a released-layout ``.pyth`` (``module.`` and
  ``ladder_net.`` names) through the port's tool and through
  ``tools/convert_checkpoint.py`` (an Orbax checkpoint): the port's
  tensors mapped through the JAX package's ``convert_clip_params`` equal
  the JAX tool's params exactly, and the two give the same per-video
  scores through the JAX test task and the port's, within 1e-4 in fp32
  (float32 sums in another order);
- ``average_checkpoints``: three port checkpoints against the JAX tool's
  ``average_trees`` on the same weights, exactly, of ``model_state`` and
  with ``--ema``; the refusals.
"""

import contextlib
import importlib.util
import io
import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

import dist_tpu.tasks.test as jax_test
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.tasks.test import test as port_test
from dist_tpu_torch.tools import average_checkpoints, convert_checkpoint
from dist_tpu_torch.utils.checkpoint import load_test_checkpoint
from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict

TINY = "configs/projects/dist/test/tiny_synth.yaml"
OPTS = ["TRAIN.MIXED_PRECISION", "false", "LOG_CONFIG_INFO", "false",
        "LOG_MODEL_INFO", "false", "DATA_LOADER.NUM_WORKERS", "0"]
# the ViT-Test preset of both packages
ARCH = dict(embed_dim=32, image_resolution=64, vision_layers=2,
            vision_width=64, vision_patch_size=16, context_length=77,
            vocab_size=49408, transformer_width=64, transformer_layers=2)
FP32_ATOL = 1e-4


def _tool(repo_root, name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(repo_root, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main(argv)
    return code, out.getvalue()


@pytest.fixture(scope="module")
def converted(repo_root, tmp_path_factory):
    """The synthetic released checkpoint and both tools' outputs."""
    tmp = tmp_path_factory.mktemp("convert")
    cfg_path = os.path.join(repo_root, TINY)
    jcfg = jax_load_config(cfg_path, OPTS, make_output_dir=False)
    rng = np.random.default_rng(0)
    sd = make_clip_state_dict(rng, **ARCH)
    add_dist_state_dict(sd, rng, JaxDiSTConfig.from_cfg(jcfg),
                        d_model=ARCH["vision_width"])
    src = str(tmp / "released.pyth")
    torch.save({"epoch": 36, "model_state": {
        "module." + k.replace("dist_net.", "ladder_net."): torch.from_numpy(
            np.asarray(v)) for k, v in sd.items()}}, src)
    dst = str(tmp / "converted.pyth")
    code, log = _quiet(convert_checkpoint.main,
                       ["--cfg", cfg_path, "--src", src, "--dst", dst])
    assert code == 0, log
    orbax = str(tmp / "orbax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["convert_checkpoint.py", "--cfg", cfg_path,
                                 "--src", src, "--dst", orbax])
        _tool(repo_root, "convert_checkpoint").main()
    return {"sd": sd, "src": src, "dst": dst, "orbax": orbax, "log": log,
            "jcfg": jcfg, "cfg_path": cfg_path, "tmp": tmp}


def test_converted_params_equal_the_jax_tools(converted):
    blob = torch.load(converted["dst"], weights_only=True)
    assert (blob["epoch"], blob["step"]) == (0, 0)
    sd = {k: v.numpy() for k, v in blob["model_state"].items()}
    assert sorted(sd) == sorted(converted["sd"])
    params, _ = convert_clip_params(
        sd, with_dist=JaxDiSTConfig.from_cfg(converted["jcfg"]))
    want = jax_load_checkpoint(converted["orbax"])["variables"]["params"]
    got_leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_convert_prints_architecture_and_count(converted):
    log = converted["log"]
    assert "Sniffed architecture: CLIPArchitecture(embed_dim=32, " \
           "image_resolution=64, vision_layers=2, vision_width=64" in log
    n = sum(int(np.prod(np.shape(v))) for v in converted["sd"].values())
    assert f"Converted {n:,} parameters" in log
    assert "not matched" not in log


def test_convert_reports_what_did_not_match(converted, tmp_path):
    """A checkpoint with a key of another shape and one the model lacks:
    both are left out and printed, with the model's key not found."""
    blob = torch.load(converted["src"], weights_only=True)
    sd = blob["model_state"]
    sd["module.visual.proj"] = torch.zeros(3, 3)
    sd["module.extra.weight"] = torch.zeros(2)
    src = str(tmp_path / "odd.pyth")
    torch.save(blob, src)
    dst = str(tmp_path / "odd_converted.pyth")
    code, log = _quiet(convert_checkpoint.main, [
        "--cfg", converted["cfg_path"], "--src", src, "--dst", dst])
    assert code == 0
    assert "Keys in model not matched (1): ['visual.proj']" in log
    assert "Keys in checkpoint not matched (2): ['extra.weight', " \
           "'visual.proj']" in log
    out = torch.load(dst, weights_only=True)["model_state"]
    assert "visual.proj" not in out and "extra.weight" not in out


def test_converted_checkpoint_loads_through_the_test_path(converted, caplog):
    cfg = load_config(converted["cfg_path"], OPTS + [
        "TEST.CHECKPOINT_FILE_PATH", converted["dst"]], make_output_dir=False)
    model = build_model(cfg, device="cpu", seed=9)
    with caplog.at_level(logging.INFO):
        load_test_checkpoint(cfg, model)
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert not [r for r in caplog.records if "not matched" in r.getMessage()]
    for k, v in model.module.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), converted["sd"][k], err_msg=k)


def test_converted_weights_give_the_jax_test_tasks_scores(converted):
    """The port's test task on the converted .pyth against the JAX test
    task on the JAX tool's Orbax checkpoint."""
    out = str(converted["tmp"] / "runs")
    meters = []

    class Recorded(jax_test.TestMeter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            meters.append(self)

    jcfg = jax_load_config(converted["cfg_path"], OPTS + [
        "OUTPUT_DIR", out, "TEST.CHECKPOINT_FILE_PATH", converted["orbax"]])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, "TestMeter", Recorded)
        want = jax_test.test(jcfg)
    got = port_test(load_config(converted["cfg_path"], OPTS + [
        "OUTPUT_DIR", out, "TEST.CHECKPOINT_FILE_PATH", converted["dst"]]),
        device="cpu")
    np.testing.assert_allclose(got.video_preds, meters[0].video_preds,
                               atol=FP32_ATOL, rtol=0)
    np.testing.assert_array_equal(got.video_labels, meters[0].video_labels)
    assert got.stats == want


@pytest.fixture(scope="module")
def soups(repo_root, tmp_path_factory):
    """Three port checkpoints (weights and an EMA copy from three seeds,
    an integer tensor that differs between them) and the port tool's
    averages of them."""
    tmp = tmp_path_factory.mktemp("soup")
    cfg = load_config(os.path.join(repo_root, TINY), OPTS,
                      make_output_dir=False)
    paths, blobs = [], []
    for seed in range(3):
        sd = build_model(cfg, device="cpu", seed=seed).module.state_dict()
        sd["counter"] = torch.tensor([seed + 1, 7], dtype=torch.int64)
        blob = {"epoch": seed, "step": 10 * seed, "model_state": sd,
                "ema": {k: v * 0.5 if v.is_floating_point() else v
                        for k, v in sd.items()}}
        paths.append(str(tmp / f"c{seed}.pyth"))
        torch.save(blob, paths[-1])
        blobs.append(blob)
    out = {}
    for name, extra in (("model_state", []), ("ema", ["--ema"])):
        out[name] = str(tmp / f"avg_{name}.pyth")
        code, _ = _quiet(average_checkpoints.main,
                         ["--ckpts", *paths, "--out", out[name], *extra])
        assert code == 0
    return {"paths": paths, "blobs": blobs, "out": out, "cfg": cfg}


@pytest.mark.parametrize("key", ["model_state", "ema"])
def test_average_equals_the_jax_tools(repo_root, soups, key):
    average_trees = _tool(repo_root, "average_checkpoints").average_trees
    want = average_trees([{k: v.numpy() for k, v in b[key].items()}
                          for b in soups["blobs"]])
    got = torch.load(soups["out"][key], weights_only=True)
    assert list(got) == ["model_state"]
    got = got["model_state"]
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
    # integer tensors take the first checkpoint's value
    assert got["counter"].tolist() == [1, 7]


def test_average_loads_through_the_test_path(soups, caplog):
    cfg = soups["cfg"]
    cfg.TEST.CHECKPOINT_FILE_PATH = soups["out"]["model_state"]
    model = build_model(cfg, device="cpu", seed=5)
    with caplog.at_level(logging.WARNING):
        load_test_checkpoint(cfg, model)
    assert not caplog.records
    avg = torch.load(soups["out"]["model_state"],
                     weights_only=True)["model_state"]
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, avg[k]), k


def test_average_refusals(repo_root, soups, tmp_path):
    """Fewer than two checkpoints; trees whose names or shapes differ,
    with the JAX assert's message; a checkpoint without the key asked
    for."""
    paths, blobs = soups["paths"], soups["blobs"]
    with pytest.raises(ValueError, match="at least two"):
        average_checkpoints.main(["--ckpts", paths[0], "--out",
                                  str(tmp_path / "x.pyth")])
    average_trees = _tool(repo_root, "average_checkpoints").average_trees
    a = {"w": np.zeros(2, np.float32)}
    with pytest.raises(AssertionError) as jax_error:
        average_trees([a, {"v": np.zeros(2, np.float32)}])
    sd = blobs[0]["model_state"]
    fewer = dict(sd)
    fewer.pop("counter")
    reshaped = dict(sd, counter=torch.zeros(3, dtype=torch.int64))
    for other in (fewer, reshaped):
        with pytest.raises(ValueError) as port_error:
            average_checkpoints.average_state_dicts([sd, other])
        assert str(port_error.value) == str(jax_error.value)
    bare = str(tmp_path / "bare.pyth")
    torch.save({"model_state": sd}, bare)
    with pytest.raises(KeyError, match="bare.pyth"):
        average_checkpoints.main(["--ckpts", paths[0], bare, "--ema",
                                  "--out", str(tmp_path / "y.pyth")])
