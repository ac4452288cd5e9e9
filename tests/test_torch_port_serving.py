"""The port's serving front: its own ``MicroBatcher`` (the counterparts of
the JAX package's batcher tests in test_serving.py) and
``VideoClassifierServer`` on the CPU at the tiny config. The port's engine
is held to the JAX engine in test_torch_port_engine.py; here the server's
HTTP answers are held to that engine's own."""

import io
import json
import os
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dist_tpu_torch.config import load_config
from dist_tpu_torch.serving import MicroBatcher
from dist_tpu_torch.serving.server import VideoClassifierServer

CFG = "configs/projects/dist/test/tiny_synth.yaml"


# ------------------------------------------------------------ batcher ----

def test_batcher_batches_and_routes_results():
    seen_batches = []

    def predict(clips):
        seen_batches.append(clips.shape[0])
        # score row i encodes the clip's own content so routing is provable
        return clips.reshape(clips.shape[0], -1)[:, :4].astype(np.float32)

    b = MicroBatcher(predict, max_batch=4, max_delay_ms=50.0)
    try:
        futs = [b.submit(np.full((2, 2), i, np.uint8)) for i in range(8)]
        for i, f in enumerate(futs):
            assert (f.result(timeout=10.0) == i).all()
        stats = b.snapshot()
        assert stats["requests"] == 8
        # 8 near-simultaneous submits through a 4-batch: at most 8 device
        # calls, and at least one multi-clip batch proves coalescing
        assert stats["batches"] <= 8
        assert max(seen_batches) > 1
        assert stats["mean_batch"] == pytest.approx(8 / stats["batches"])
    finally:
        b.close()


def _predict_raises(clips):
    if (clips == 13).any():
        raise ValueError("unlucky clip")
    return np.zeros((clips.shape[0], 2), np.float32)


@pytest.mark.parametrize("bad_clips,max_batch,delay_ms", [
    # predict_fn raises for the batch holding the bad clip
    ([np.full((2, 2), 13, np.uint8)], 1, 1.0),
    # np.stack of a mixed-shape batch fails outside predict_fn
    ([np.zeros((2, 2), np.uint8), np.zeros((3, 3), np.uint8)], 2, 200.0),
], ids=["predict_raises", "mismatched_shapes"])
def test_batcher_fails_the_batch_and_recovers(bad_clips, max_batch,
                                              delay_ms):
    """A failing batch fails its own futures and never kills the dispatch
    thread (a dead thread would hang every later submit)."""
    b = MicroBatcher(_predict_raises, max_batch=max_batch,
                     max_delay_ms=delay_ms)
    try:
        futs = [b.submit(c) for c in bad_clips]   # one gather window
        for f in futs:
            with pytest.raises(ValueError):
                f.result(timeout=10.0)
        good = b.submit(np.zeros((2, 2), np.uint8))
        assert good.result(timeout=10.0).shape == (2,)
        assert b.snapshot()["errors"] == len(bad_clips)
    finally:
        b.close()


def test_batcher_backpressure_and_close_semantics():
    """Bounded queue: overload raises queue.Full (the server answers 503);
    close() fails queued futures fast and rejects later submits; a
    caller-side cancel racing set_result never kills the dispatch thread."""
    release = threading.Event()

    def slow_predict(clips):
        release.wait(timeout=10.0)
        return np.zeros((clips.shape[0], 2), np.float32)

    b = MicroBatcher(slow_predict, max_batch=1, max_delay_ms=1.0,
                     max_queue=2)
    try:
        first = b.submit(np.zeros((2,), np.uint8))  # occupies the device
        time.sleep(0.1)  # let the dispatch thread take it
        queued = [b.submit(np.zeros((2,), np.uint8)) for _ in range(2)]
        with pytest.raises(queue.Full):
            for _ in range(8):  # the bound must bite within max_queue
                b.submit(np.zeros((2,), np.uint8))
        assert b.snapshot()["rejected"] >= 1
        queued[0].cancel()
    finally:
        release.set()
        first.result(timeout=10.0)
        b.close()
    assert not b._thread.is_alive()
    for f in queued:
        if f.cancelled():
            continue
        try:
            # completed before close() or failed fast by its drain: the
            # guarantee under test is no hang (the 1 s timeout)
            f.result(timeout=1.0)
        except RuntimeError:
            pass
    with pytest.raises(RuntimeError):
        b.submit(np.zeros((2,), np.uint8))


def test_batcher_respects_max_batch():
    sizes = []

    def predict(clips):
        sizes.append(clips.shape[0])
        time.sleep(0.02)  # let the queue back up
        return np.zeros((clips.shape[0], 1), np.float32)

    b = MicroBatcher(predict, max_batch=3, max_delay_ms=100.0)
    try:
        futs = [b.submit(np.zeros((1,), np.uint8)) for _ in range(9)]
        for f in futs:
            f.result(timeout=10.0)
        assert max(sizes) <= 3
    finally:
        b.close()


# ------------------------------------------------------- engine + http ----

@pytest.fixture(scope="module")
def tiny_server(repo_root):
    cfg = load_config(os.path.join(repo_root, CFG), make_output_dir=False)
    server = VideoClassifierServer(cfg, host="127.0.0.1", port=0,
                                   batch_size=8, max_delay_ms=20.0,
                                   device="cpu")
    with server:
        yield server


def _request(port, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, headers=headers or {},
        method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _npy(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _clip_shape(server):
    e = server.engine
    return (e.num_frames, e.crop, e.crop, 3)


def test_server_predicts_and_batches(tiny_server):
    port = tiny_server.port
    status, health = _request(port, "/v1/health")
    assert status == 200
    assert health == {"status": "ok", "classes": 12, "frames": 4, "crop": 64,
                      "batch_size": 8}
    rng = np.random.default_rng(0)
    clips = rng.integers(0, 255, (6,) + _clip_shape(tiny_server), np.uint8)
    before = tiny_server.batcher.snapshot()["requests"]
    results = [None] * 6

    def worker(i):
        results[i] = _request(port, "/v1/predict?topk=3", _npy(clips[i]))

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for status, payload in results:
        assert status == 200
        assert len(payload["topk"]) == 3
        scores = [row["score"] for row in payload["topk"]]
        assert scores == sorted(scores, reverse=True)
        assert all(0 <= row["class"] < 12 for row in payload["topk"])
    status, stats = _request(port, "/v1/stats")
    assert status == 200
    # warmup's batches bypass the batcher
    assert stats["requests"] - before == 6
    assert stats["mean_batch"] >= 1.0


def test_http_topk_equals_the_engines_own(tiny_server):
    """One clip at a time, so both sides run the same bucket of one: the
    HTTP answer equals ``engine.topk(engine.predict(clip))`` exactly."""
    engine = tiny_server.engine
    rng = np.random.default_rng(3)
    for _ in range(2):
        clip = rng.integers(0, 255, _clip_shape(tiny_server), np.uint8)
        status, payload = _request(tiny_server.port, "/v1/predict?topk=5",
                                   _npy(clip))
        assert status == 200
        want = engine.topk(engine.predict(clip[None]), k=5)[0]
        assert [(r["class"], r["label"], r["score"])
                for r in payload["topk"]] == want


@pytest.mark.parametrize("body,headers,code", [
    (_npy(np.zeros((2, 2), np.uint8)), None, 400),          # wrong shape
    (_npy(np.zeros((4, 64, 64, 3), np.float32)), None, 400),  # not uint8
    (b"not-npy", None, 400),                                 # garbage
    (b"", {"Content-Length": "-1"}, 400),                    # negative
    (b"", {"Content-Length": str(65 * 2 ** 20)}, 413),       # oversized
], ids=["shape", "dtype", "garbage", "negative_length", "oversized"])
def test_server_rejects_bad_payloads(tiny_server, body, headers, code):
    status, payload = _request(tiny_server.port, "/v1/predict", body, headers)
    assert status == code
    assert "error" in payload


def test_server_unknown_paths(tiny_server):
    assert _request(tiny_server.port, "/v2/health")[0] == 404
    assert _request(tiny_server.port, "/v2/predict", b"x")[0] == 404


def test_health_waits_for_warmup(repo_root):
    """Without warm-up the server answers 503 until its engine has served
    a request."""
    cfg = load_config(os.path.join(repo_root, CFG), make_output_dir=False)
    server = VideoClassifierServer(cfg, host="127.0.0.1", port=0,
                                   batch_size=2, warmup=False, device="cpu")
    with server:
        assert _request(server.port, "/v1/health") == (
            503, {"status": "warming_up"})
        clip = np.zeros(_clip_shape(server), np.uint8)
        assert _request(server.port, "/v1/predict", _npy(clip))[0] == 200
        assert _request(server.port, "/v1/health")[0] == 200


def test_server_needs_a_card_unless_told(repo_root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(repo_root, CFG), make_output_dir=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VideoClassifierServer(cfg, host="127.0.0.1", port=0, batch_size=2)
