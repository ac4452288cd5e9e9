"""The port's binding of ``native/videodec.cpp`` against the JAX
package's binding of the same source, on a clip written with OpenCV in
the test (the test may use OpenCV; the port may not). Skips where the
port's library does not build. Without the library the port's
``read_video`` raises and says why: there is no OpenCV fallback."""

import numpy as np
import pytest

from dist_tpu.data import native_decoder as jax_nd
from dist_tpu_torch.data import base_dataset
from dist_tpu_torch.data import native_decoder as nd


@pytest.fixture(scope="module")
def video_file(tmp_path_factory):
    import cv2

    if not nd.available():
        pytest.skip(f"native decoder: {nd.status()}")
    path = str(tmp_path_factory.mktemp("nv") / "clip.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    base = np.random.default_rng(0).integers(0, 256, (48, 64, 3), np.uint8)
    for i in range(60):
        w.write(np.roll(base, i, axis=1))
    w.release()
    return path


def test_probe_matches_jax(video_file):
    assert nd.probe(video_file) == jax_nd.probe(video_file)
    assert nd.probe(video_file)[0] == 60
    assert base_dataset.probe_video(video_file) == nd.probe(video_file)[:2]


@pytest.mark.parametrize("idx", [[0, 7, 31, 59], [10, 58, 59], [58, 70]])
@pytest.mark.parametrize("out_hw", [(0, 0), (24, 32)])
def test_decode_matches_jax(video_file, idx, out_hw):
    got = nd.decode(video_file, idx, *out_hw)
    np.testing.assert_array_equal(got, jax_nd.decode(video_file, idx, *out_hw))
    if out_hw == (0, 0):
        np.testing.assert_array_equal(
            base_dataset.read_video(video_file, idx), got)


def test_decode_batch_matches_jax(video_file):
    lists = [[0, 5], [59, 3, 3], [20]]
    got = nd.decode_batch([video_file] * 3, lists, 24, 32, num_threads=2)
    want = jax_nd.decode_batch([video_file] * 3, lists, 24, 32, num_threads=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_missing_file_raises_ioerror(video_file, tmp_path):
    with pytest.raises(IOError):
        nd.decode(str(tmp_path / "missing.mp4"), [0])


def test_unavailable_decoder_raises_with_its_reason(monkeypatch):
    monkeypatch.setattr(nd, "_lib", None)
    monkeypatch.setattr(nd, "_error", "g++ failed on videodec.cpp")
    assert not nd.available()
    assert nd.status() == "unavailable: g++ failed on videodec.cpp"
    with pytest.raises(RuntimeError, match="unavailable: g.. failed"):
        base_dataset.read_video("any.mp4", [0])
