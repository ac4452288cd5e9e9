"""The port's input-pipeline bench (``tools/bench_pipeline.py``) and its mp4
writer (``data/videoenc.cpp`` through ``data/native_encoder.py``) on the
CPU, against the JAX package:

- the port's mp4 is what the JAX package's ``probe_video`` reads as 48
  frames at 30 fps, and the native decoder as 256 x 256;
- the bench's videos through the port's loader and the JAX package's
  give the same batches (test split, the flagship's crop), bit for bit;
- the tool's loader-only line at 4 videos with ``BENCH_DEVICE=0`` has
  the JAX tool's keys, and its sweep a line per worker count;
- without FFmpeg the tool raises at once with the decoder's status."""

import json
import os

import numpy as np
import pytest

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data.base_dataset import probe_video
from dist_tpu.data.builder import build_loader as jax_build_loader
from dist_tpu_torch.data import native_decoder, native_encoder
from dist_tpu_torch.data.builder import build_loader
from dist_tpu_torch.tools import bench_pipeline as bp

# the JAX tool's JSON keys (tools/bench_pipeline.py)
LOADER_KEYS = {"metric", "value", "videos", "workers", "worker_type",
               "split", "aug", "host_cores"}
N = 4

@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    for mod in (native_encoder, native_decoder):
        if mod.status() != "native":
            pytest.skip(f"FFmpeg's libraries are needed: {mod.status()}")
    d = str(tmp_path_factory.mktemp("bench_videos"))
    bp.make_videos(d, N)
    return d


def test_mp4_probes_as_the_jax_tools_video(videos):
    for i in range(N):
        path = os.path.join(videos, f"v{i:04d}.mp4")
        assert probe_video(path) == (bp.N_FRAMES, bp.FPS)
        assert native_decoder.probe(path)[2:] == bp.RES


def test_frames_are_the_rolled_frame(videos):
    """Each frame is the seeded frame rolled 3 columns a step, up to the
    codec's loss (4:2:0 chroma of noise): frame t against frame 0 rolled
    is as close as frame 0 is to the source."""
    path = os.path.join(videos, "v0001.mp4")
    frames = native_decoder.decode(path, np.arange(bp.N_FRAMES))
    base = np.random.default_rng(1).integers(0, 256, (256, 256, 3),
                                             np.uint8)[..., ::-1]
    first = np.abs(frames[0].astype(int) - base).mean()
    assert first < 60
    for t in (1, 17, 47):
        rolled = np.roll(base, t * 3, axis=1)
        assert np.abs(frames[t].astype(int) - rolled).mean() < first + 5


def test_loaders_give_the_same_batches(videos):
    cfg = bp.load_cfg(videos, 2)
    jcfg = jax_load_config(
        os.path.join(bp._repo(), bp.FLAGSHIP),
        ["TEST.DATASET", "kinetics400", "TEST.BATCH_SIZE", "2",
         "TEST.NUM_ENSEMBLE_VIEWS", "1", "TEST.NUM_SPATIAL_CROPS", "1",
         "DATA.DATA_ROOT_DIR", videos, "DATA.ANNO_DIR", videos,
         "DATA.DATASET_LABEL_TEXT.ENABLE", "false"], make_output_dir=False)
    port = build_loader(cfg, "test", device="cpu")
    try:
        got = [{k: np.asarray(v) for k, v in b.items()} for b in port]
    finally:
        port.close()
    want = list(jax_build_loader(jcfg, "test"))

    def clips(batches):
        """Every real clip (the pad mask's), by dataset index."""
        rows = [(int(i), v, int(lb)) for b in batches
                for i, v, lb, m in zip(b["index"], np.asarray(b["video"]),
                                       b["label"], b["_mask"]) if m > 0]
        return sorted(rows, key=lambda r: r[0])

    g, w = clips(got), clips(want)
    assert [r[0] for r in g] == [r[0] for r in w] == list(range(N))
    for (i, gv, gl), (_, wv, wl) in zip(g, w):
        assert gv.shape == (16, 224, 224, 3)
        np.testing.assert_array_equal(gv, wv, f"clip {i}")
        assert gl == wl


def test_loader_line_has_the_jax_tools_keys(videos, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DEVICE", "0")
    monkeypatch.setenv("BENCH_BATCH", "2")
    assert bp.main([str(N), "--video-dir", videos, "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert len(lines) == 1 and set(lines[0]) == LOADER_KEYS
    assert lines[0]["metric"] == "loader_clips_per_sec"
    assert lines[0]["videos"] == N and lines[0]["value"] > 0


def test_sweep_prints_a_line_per_worker_count(videos, monkeypatch):
    """``BENCH_SWEEP``: a loader line a worker count."""
    monkeypatch.setenv("BENCH_SWEEP", "1,2")
    monkeypatch.setenv("BENCH_BATCH", "2")
    lines = bp.run(N, videos, "cpu")
    assert [x["workers"] for x in lines] == [1, 2]
    assert all(set(x) == LOADER_KEYS for x in lines)


def test_without_ffmpeg_it_raises_with_the_status(monkeypatch, tmp_path):
    monkeypatch.setattr(native_decoder, "status",
                        lambda: "unavailable: libavformat not found")
    with pytest.raises(RuntimeError, match="libavformat not found"):
        bp.run(N, str(tmp_path), "cpu")
    assert not os.listdir(tmp_path)
