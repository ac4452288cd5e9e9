"""The port's ``classify`` tool against the JAX package's
(``tools/classify.py``, run in this process) on an mp4 written here with
OpenCV (the test may use OpenCV; the port may not), at the tiny geometry
of ``tiny_synth.yaml`` in fp32 with 2 views of 3 crops, one ``.pyth``
checkpoint and a ``labels.json``: the same decoded views, per-class
scores within 1e-4 (float32 sums in another order) and the same printed
top-k, replicated and under ``TPU.SHARD_FRAMES``. Skips where the port's native decoder does not build, as
``tests/test_torch_port_native_decoder.py`` does."""

import contextlib
import importlib.util
import io
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

import dist_tpu.tasks.state as jax_state
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import sampling as jax_sampling
from dist_tpu.data.base_dataset import read_video as jax_read_video
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import native_decoder as nd
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.tools import classify

TINY = "configs/projects/dist/test/tiny_synth.yaml"
CLASSES = 12
FP32_ATOL = 1e-4


@pytest.fixture(scope="module")
def case(repo_root, tmp_path_factory):
    import cv2

    if not nd.available():
        pytest.skip(f"native decoder: {nd.status()}")
    tmp = tmp_path_factory.mktemp("classify")
    video = str(tmp / "clip.mp4")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 30, (80, 48))
    base = np.random.default_rng(0).integers(0, 256, (48, 80, 3), np.uint8)
    for i in range(60):
        w.write(np.roll(base, 3 * i, axis=1))
    w.release()
    with open(tmp / "labels.json", "w") as f:
        json.dump({f'"class {i} name"': i for i in range(CLASSES)}, f)
    ckpt = str(tmp / "weights.pyth")
    opts = ["TRAIN.MIXED_PRECISION", "false", "TEST.NUM_ENSEMBLE_VIEWS", "2",
            "TEST.NUM_SPATIAL_CROPS", "3", "DATA.ANNO_DIR", str(tmp),
            "TEST.CHECKPOINT_FILE_PATH", ckpt, "OUTPUT_DIR", str(tmp / "out")]
    cfg_path = os.path.join(repo_root, TINY)
    cfg = load_config(cfg_path, opts, make_output_dir=False)
    torch.save({"model_state": build_model(cfg, device="cpu", seed=4)
                .module.state_dict()}, ckpt)
    return {"video": video, "cfg_path": cfg_path, "opts": opts, "cfg": cfg}


def _jax_classify(repo_root, argv):
    """(printed text, the eval step's preds of each video) of the JAX
    tool."""
    spec = importlib.util.spec_from_file_location(
        "jax_classify", os.path.join(repo_root, "tools", "classify.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    preds = []
    make = jax_state.make_eval_step

    def recording(model, cfg):
        step = make(model, cfg)

        def wrapped(state, batch):
            # the tool jits the step: the preds are read as it runs
            out = step(state, batch)
            jax.debug.callback(lambda p: preds.append(np.asarray(p)),
                               out["preds"])
            return out
        return wrapped

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(jax_state, "make_eval_step", recording)
        mp.setattr(sys, "argv", ["classify.py"] + argv)
        mod.main()
    return out.getvalue(), preds


def _printed(text):
    """[(rank, name, score)] of a tool's printout."""
    return [(int(m[1]), m[2], float(m[3])) for m in re.finditer(
        r"^  (\d+)\. (.+)  \(score (-?[\d.]+)\)$", text, re.M)]


def test_views_decode_as_jax(case):
    cfg = case["cfg"]
    jcfg = jax_load_config(case["cfg_path"], case["opts"],
                           make_output_dir=False)
    views = classify.decode_views(cfg, case["video"])
    assert len(views) == 2
    for v, frames in enumerate(views):
        idx = jax_sampling.get_frame_indices(
            jcfg, 60, 30.0, v, 2, rng=np.random.default_rng(0),
            random_sample=False)
        np.testing.assert_array_equal(frames,
                                      jax_read_video(case["video"], idx))


def test_scores_and_top_k_match_jax(repo_root, case):
    argv = ["--cfg", case["cfg_path"], "--videos", case["video"],
            "--topk", "5", *case["opts"]]
    jax_text, jax_preds = _jax_classify(repo_root, argv)
    (preds,) = jax_preds
    assert preds.shape == (6, CLASSES)
    want = preds.sum(axis=0)

    cfg = case["cfg"]
    model, names, text = classify.load_classifier(cfg, "cpu")
    assert names == [f"class {i} name" for i in range(CLASSES)]
    got = classify.score_video(cfg, model, text,
                               classify.decode_views(cfg, case["video"]))
    np.testing.assert_allclose(got, want, atol=FP32_ATOL, rtol=0)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert classify.main(argv[:4] + ["--device", "cpu"] + argv[4:]) == 0
    port, jax = _printed(out.getvalue()), _printed(jax_text)
    assert len(port) == len(jax) == 5
    assert [r[:2] for r in port] == [r[:2] for r in jax]
    # printed with 4 decimals: within 1e-4 each, and the rounding's step
    for (_, _, a), (_, _, b) in zip(port, jax):
        assert abs(a - b) <= FP32_ATOL + 1e-4
    assert out.getvalue().splitlines()[1] == f"{case['video']}:"


def test_scores_under_shard_frames_match_jax(repo_root, case, tmp_path):
    """``TPU.SHARD_FRAMES`` at 8 frames: the JAX tool, its 6 clips'
    frames sharded over its data axis of 8, against the port's, the 4
    kept frames spread over two CPU replicas (``--devices cpu,cpu``):
    per-class scores within 1e-4 and the same printed top-k. The
    checkpoint is made at 8 frames (the side network's temporal
    embeddings have T's shape)."""
    from dist_tpu_torch.parallel import local

    ckpt = str(tmp_path / "weights8.pyth")
    opts = [*case["opts"], "DATA.NUM_INPUT_FRAMES", "8",
            "TEST.CHECKPOINT_FILE_PATH", ckpt]
    cfg = load_config(case["cfg_path"], opts, make_output_dir=False)
    torch.save({"model_state": build_model(cfg, device="cpu", seed=4)
                .module.state_dict()}, ckpt)
    opts += ["TPU.SHARD_FRAMES", "true"]
    argv = ["--cfg", case["cfg_path"], "--videos", case["video"],
            "--topk", "5", *opts]
    jax_text, (preds,) = _jax_classify(repo_root, argv)
    assert preds.shape == (6, CLASSES)

    cfg = load_config(case["cfg_path"], opts, make_output_dir=False)
    model, _, text = classify.load_classifier(cfg, "cpu", ["cpu", "cpu"])
    assert isinstance(model.module.tower_runner, local.FrameParallelTower)
    got = classify.score_video(cfg, model, text,
                               classify.decode_views(cfg, case["video"]))
    np.testing.assert_allclose(got, preds.sum(axis=0), atol=FP32_ATOL,
                               rtol=0)

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert classify.main(argv[:4] + ["--device", "cpu", "--devices",
                                         "cpu,cpu"] + argv[4:]) == 0
    port, jax = _printed(out.getvalue()), _printed(jax_text)
    assert len(port) == len(jax) == 5
    assert [r[:2] for r in port] == [r[:2] for r in jax]
    for (_, _, a), (_, _, b) in zip(port, jax):
        assert abs(a - b) <= FP32_ATOL + 1e-4


def test_refusals(repo_root, case, monkeypatch):
    """The dual-head refusal with the JAX assert's message, frame-parallel
    inference inside a group of more than one rank (as the JAX package
    asserts a single process; in one process it runs:
    ``test_torch_port_local_devices.py``) and a missing card."""
    dual = ["VIDEO.HEAD.NUM_CLASSES", "[97, 300]"]
    spec = importlib.util.spec_from_file_location(
        "jax_classify", os.path.join(repo_root, "tools", "classify.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # --topk ends the list of videos
    argv = ["--cfg", case["cfg_path"], "--videos", "x.mp4", "--topk", "5"]
    monkeypatch.setattr(sys, "argv", ["classify.py", *argv, *dual])
    with pytest.raises(AssertionError) as jax_error:
        mod.main()
    with pytest.raises(ValueError) as port_error:
        classify.main([*argv, "--device", "cpu", *dual])
    assert str(port_error.value) == str(jax_error.value)
    with monkeypatch.context() as m:
        m.setattr(torch.distributed, "is_initialized", lambda: True)
        m.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
        with pytest.raises(ValueError, match="SHARD_FRAMES"):
            classify.main([*argv, "--device", "cpu", "TPU.SHARD_FRAMES",
                           "true"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        classify.main(argv)
