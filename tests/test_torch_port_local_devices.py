"""One process over a list of local devices (``parallel/local.py``) on the
CPU, with two (or three) CPU replicas standing in for the cards:

- the serving engine over two replicas against one device: a bucket the
  replicas divide is split and gathered in order, a smaller one runs on
  the first; the weights reach every replica;
- ``TPU.SHARD_FRAMES``: the CLIP tower's kept frames spread over the
  replicas (evenly and not), the taps gathered along T, the side network
  on the first device: the eval step, the test task and
  ``tools/classify.py``'s scoring against the replicated run; a backbone
  with no CLIP tower computes on the first device and says so.
- Against the JAX package on its 8-device CPU mesh, from one ``.pyth``
  made by the port from a seed (``jax_side``): the engine over two
  replicas against the JAX engine, whose bucket of 8 splits over the
  data axis; the frame-parallel eval step against the JAX eval step of
  a batch placed by ``shard_batch(shard_frames=True)``; the test task
  under ``TPU.SHARD_FRAMES`` against the JAX test task under it. (The
  classify tool under it is held to the JAX tool in
  ``test_torch_port_classify.py``.)"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dist_tpu.tasks.test as jax_test
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.parallel.mesh import shard_batch
from dist_tpu.serving.engine import InferenceEngine as JaxInferenceEngine
from dist_tpu.tasks.state import make_eval_step as jax_make_eval_step
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.base.models import build_model
from dist_tpu_torch.parallel import local
from dist_tpu_torch.serving.engine import InferenceEngine
from dist_tpu_torch.tasks import test as test_task
from dist_tpu_torch.tasks.state import make_eval_step
from dist_tpu_torch.utils.checkpoint import load_test_checkpoint

TINY = "configs/projects/dist/test/tiny_synth.yaml"
FP32 = ["TRAIN.MIXED_PRECISION", "false"]
# 8 frames: 4 kept at alpha 2, two a replica
FRAMES = ["DATA.NUM_INPUT_FRAMES", "8"]
CPU2 = ["cpu", "cpu"]
# fp32 rows computed in another batch: the engine's and the tower's
# matmuls block differently (the JAX SHARD_FRAMES test's 2e-5 is its
# sharded reductions')
SCORE_ATOL = 1e-6
# against the JAX package in fp32: the port's engine against JAX's
# (test_torch_port_engine.py's 1e-5: sums in another order), the eval
# step against JAX's frame-sharded one (the JAX SHARD_FRAMES test's
# 2e-5), the test task's ensembled scores against JAX's
# (test_torch_port_test_task.py's run-list 1e-4)
JAX_ENGINE_ATOL = 1e-5
JAX_EVAL_ATOL = 2e-5
JAX_TASK_ATOL = 1e-4
TASK_OPTS = ["TEST.BATCH_SIZE", "1", "TEST.NUM_SAMPLES_LIMIT", "4",
             "TRAIN.ENABLE", "false"]


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads while this file runs: the suite runs in
    several worker processes at once, and every core in each of them
    would oversubscribe the host many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(repo_root, *opts):
    return load_config(os.path.join(repo_root, TINY), FP32 + list(opts),
                       make_output_dir=False)


def _clips(cfg, n, seed=0):
    t, s = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TEST_CROP_SIZE)
    return np.random.default_rng(seed).integers(0, 256, (n, t, s, s, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def engines(repo_root):
    cfg = _cfg(repo_root)
    return (InferenceEngine(cfg, batch_size=4, device="cpu"),
            InferenceEngine(cfg, batch_size=4, devices=CPU2))


def _text(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (12, 32)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side(repo_root, tmp_path_factory):
    """One ``.pyth`` made by the port (seed 0) and the JAX package's
    runs from it on its 8-device CPU mesh: the engine at batch size 8
    (the port's options beside it), the eval step's scores of 1 and 2
    clips with their frames sharded over the data axis, and the test
    task's meter under ``TPU.SHARD_FRAMES``."""
    out = str(tmp_path_factory.mktemp("jax_side"))
    ckpt = os.path.join(out, "weights.pyth")
    opts = FP32 + FRAMES + ["TEST.CHECKPOINT_FILE_PATH", ckpt]
    torch.save(build_model(_cfg(repo_root, *FRAMES), device="cpu", seed=0)
               .module.state_dict(), ckpt)
    path = os.path.join(repo_root, TINY)
    engine = JaxInferenceEngine(
        jax_load_config(path, opts, make_output_dir=False), batch_size=8)
    assert engine.mesh.devices.size == 8
    step = jax.jit(jax_make_eval_step(engine.model, engine.cfg))
    evals = {}
    with engine.mesh:
        for n in (1, 2):
            batch = shard_batch(engine.mesh, {
                "video": _clips(engine.cfg, n),
                "labels": np.zeros((n,), np.int64)}, shard_frames=True)
            # the frames, not the clips, lie over the data axis
            assert "data" in str(batch["video"].sharding.spec[1])
            batch["text_features"] = jnp.asarray(_text())
            evals[n] = np.asarray(step(engine.state, batch)["preds"])
    meters = []

    class Recorded(jax_test.TestMeter):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            meters.append(self)

    task_opts = opts + TASK_OPTS + ["OUTPUT_DIR", out, "TPU.SHARD_FRAMES",
                                    "true"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_test, "TestMeter", Recorded)
        results = jax_test.test(jax_load_config(path, task_opts))
    return {"opts": opts, "task_opts": task_opts, "engine": engine,
            "evals": evals, "meter": meters[0], "results": results}


@pytest.mark.parametrize("n", [2, 5, 8])
def test_engine_over_two_replicas_matches_jax(repo_root, jax_side, n):
    """The port's engine over two CPU replicas against the JAX engine:
    buckets 2 and 8 split 1 + 1 and 4 + 4 over the replicas; JAX's bucket
    of 8 splits over its data axis of 8, its bucket of 2 it replicates.
    Scores and top-5 of each request."""
    want_engine = jax_side["engine"]
    engine = InferenceEngine(_cfg(repo_root, *jax_side["opts"]),
                             batch_size=8, devices=CPU2)
    clips = _clips(engine.cfg, n, seed=10 + n)
    got, want = engine.predict(clips), want_engine.predict(clips)
    np.testing.assert_allclose(got, want, rtol=0, atol=JAX_ENGINE_ATOL)
    assert [[c for c, _, _ in row] for row in engine.topk(got)] == [
        [c for c, _, _ in row] for row in want_engine.topk(want)]


@pytest.mark.parametrize("devices", [2, 3])
def test_shard_frames_eval_matches_jax(repo_root, jax_side, devices):
    """The port's frame-parallel eval step (4 kept frames over 2 and 3
    replicas) against the JAX eval step of the same clips with their
    frames sharded over its data axis, at batch 1 and 2."""
    cfg = _cfg(repo_root, *jax_side["opts"])
    model = build_model(cfg, device="cpu", seed=1)
    load_test_checkpoint(cfg, model)
    split = local.shard_frames(model, [torch.device("cpu")] * devices)
    assert isinstance(split.module.tower_runner, local.FrameParallelTower)
    step = make_eval_step(split, cfg)
    for n, want in jax_side["evals"].items():
        batch = {"video": torch.from_numpy(_clips(cfg, n)),
                 "text_features": torch.from_numpy(_text())}
        np.testing.assert_allclose(step(batch)["preds"].numpy(), want,
                                   rtol=0, atol=JAX_EVAL_ATOL)


def test_shard_frames_test_task_matches_jax(repo_root, jax_side):
    """The test task under ``TPU.SHARD_FRAMES`` over two replicas against
    the JAX test task under it: the same batches of ``TEST.BATCH_SIZE``,
    labels and clip counts, ensembled scores within the run list's
    tolerance, the same top-1 and top-5 accuracies."""
    want = jax_side["meter"]
    got = test_task.test(_cfg(repo_root, *jax_side["task_opts"]),
                         device="cpu", devices=CPU2)
    assert got.timing["batches"] == 4
    np.testing.assert_allclose(got.video_preds, want.video_preds,
                               rtol=0, atol=JAX_TASK_ATOL)
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_array_equal(got.clip_count, want.clip_count)
    for k in ("top1_acc", "top5_acc"):
        assert got.stats[k] == jax_side["results"][k], k


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_engine_over_two_replicas_matches_one_device(engines, n):
    """Each request's scores and top-5; buckets 2 and 4 split over the two
    replicas in order (each replica's eval step runs once), bucket 1 runs
    on the first alone."""
    one, two = engines
    assert two.buckets() == one.buckets() == [1, 2, 4]
    assert len(two.replicas) == 2 and two.devices == [torch.device("cpu")] * 2
    calls = []
    steps = two.replicas.steps
    two.replicas.steps = [
        (lambda s, i: lambda b: calls.append((i, len(b["video"]))) or s(b))(
            s, i) for i, s in enumerate(steps)]
    clips = _clips(one.cfg, n, seed=n)
    try:
        got = two.predict(clips)
    finally:
        two.replicas.steps = steps
    want = one.predict(clips)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ATOL)
    assert [[c for c, _, _ in row] for row in two.topk(got)] == [
        [c for c, _, _ in row] for row in one.topk(want)]
    bucket = next(b for b in one.buckets() if b >= n)
    assert calls == ([(0, bucket // 2), (1, bucket // 2)] if bucket > 1
                     else [(0, 1)])


def test_engine_weights_reach_every_replica(engines):
    """``load_state_dict`` replaces every replica's weights."""
    _, two = engines
    sd = {k: v + 0.01 for k, v in two.model.module.state_dict().items()}
    two.load_state_dict(sd)
    try:
        for m in two.replicas.models:
            for k, v in m.module.state_dict().items():
                torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    finally:
        two.load_state_dict({k: v - 0.01 for k, v in sd.items()})


def test_engine_text_features_set_reach_every_replica(engines):
    """Text features set on the engine (as a caller that computes its own
    does) are what every replica scores against, split or not."""
    one, two = engines
    before = one.text_features
    text = torch.from_numpy(_text(1)) if before is None else before.flip(0)
    clips = _clips(one.cfg, 4, seed=7)
    try:
        for e in (one, two):
            e.text_features = text
        assert all(t is not None and t.device == d for t, d in
                   zip(two._replica_text, two.devices))
        for n in (1, 4):
            np.testing.assert_allclose(two.predict(clips[:n]),
                                       one.predict(clips[:n]), rtol=0,
                                       atol=SCORE_ATOL)
        got = one.predict(clips)
    finally:
        for e in (one, two):
            e.text_features = before
    # the features set were the ones scored against
    assert not np.allclose(got, one.predict(clips), rtol=0, atol=1e-3)


@pytest.mark.parametrize("devices", [2, 3])
def test_shard_frames_eval_matches_replicated(repo_root, devices):
    """The frame-parallel tower (4 kept frames over 2 replicas, and over 3
    unevenly) against the one-device eval step, at batch 1 and 2."""
    cfg = _cfg(repo_root, *FRAMES)
    ref = build_model(cfg, device="cpu", seed=0)
    split = local.shard_frames(build_model(cfg, device="cpu", seed=0),
                               [torch.device("cpu")] * devices)
    assert isinstance(split.module.tower_runner, local.FrameParallelTower)
    text = torch.randn(12, 32, generator=torch.Generator().manual_seed(0))
    for n in (1, 2):
        batch = {"video": torch.from_numpy(_clips(cfg, n)),
                 "text_features": text}
        np.testing.assert_allclose(
            make_eval_step(split, cfg)(batch)["preds"].numpy(),
            make_eval_step(ref, cfg)(batch)["preds"].numpy(),
            rtol=0, atol=SCORE_ATOL)


def test_shard_frames_test_task_matches_replicated(repo_root, tmp_path):
    """The whole test task under ``TPU.SHARD_FRAMES`` over two replicas:
    the loader's batch stays ``TEST.BATCH_SIZE`` and the ensembled scores
    and accuracies are the replicated run's."""
    opts = [*FRAMES, "TEST.BATCH_SIZE", "1", "TEST.NUM_SAMPLES_LIMIT", "4",
            "TRAIN.ENABLE", "false", "OUTPUT_DIR", str(tmp_path)]
    plain = test_task.test(_cfg(repo_root, *opts), device="cpu")
    sharded = test_task.test(_cfg(repo_root, *opts, "TPU.SHARD_FRAMES",
                                  "true"), device="cpu", devices=CPU2)
    assert sharded.timing["batches"] == plain.timing["batches"] == 4
    np.testing.assert_allclose(sharded.video_preds, plain.video_preds,
                               rtol=0, atol=SCORE_ATOL)
    assert sharded.stats == plain.stats


def test_classify_scores_under_shard_frames(repo_root):
    """``tools/classify.py``'s model path (``load_classifier`` and
    ``score_video``) over two replicas against one device, on decoded
    views made from a seed."""
    from dist_tpu_torch.tools import classify

    cfg = _cfg(repo_root, *FRAMES, "TEST.NUM_ENSEMBLE_VIEWS", "2",
               "TEST.NUM_SPATIAL_CROPS", "3")
    views = list(np.random.default_rng(1).integers(
        0, 256, (2, 8, 72, 96, 3), dtype=np.uint8))
    want = classify.score_video(cfg, *_drop_names(
        classify.load_classifier(cfg, "cpu")), views)
    shard = _cfg(repo_root, *FRAMES, "TEST.NUM_ENSEMBLE_VIEWS", "2",
                 "TEST.NUM_SPATIAL_CROPS", "3", "TPU.SHARD_FRAMES", "true")
    model, _, text = classify.load_classifier(shard, "cpu", CPU2)
    assert isinstance(model.module.tower_runner, local.FrameParallelTower)
    np.testing.assert_allclose(classify.score_video(shard, model, text, views),
                               want, rtol=0, atol=6 * SCORE_ATOL)


def _drop_names(loaded):
    model, _, text = loaded
    return model, text


def test_shard_frames_without_a_clip_tower(repo_root, caplog):
    """A backbone with no CLIP tower computes on the first device, with
    one log line that its frames are not split."""
    from tests.test_torch_port_tada_run import OPTS as TADA_OPTS

    cfg = load_config(os.path.join(
        repo_root, "configs/projects/tada/k400/tada2d_8x8.yaml"),
        TADA_OPTS, make_output_dir=False)
    model = build_model(cfg, device="cpu", seed=0)
    local._NOT_SPLIT_LOGGED.discard(type(model.module).__name__)
    with caplog.at_level("INFO"):
        assert local.shard_frames(model, [torch.device("cpu")] * 2) is model
        local.shard_frames(model, [torch.device("cpu")] * 2)
    assert caplog.text.count("frames are not split") == 1
    assert not hasattr(model.module, "tower_runner")


def test_local_devices_and_what_the_engine_refuses(repo_root, monkeypatch):
    """The default devices: every local card, or the one named; the
    engine serves the data axis alone."""
    assert local.local_devices("cpu") == [torch.device("cpu")]
    assert local.local_devices(None, CPU2) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert local.local_devices(None) == [torch.device("cuda", i)
                                         for i in range(3)]
    monkeypatch.undo()
    for axis in ("TPU.MESH.MODEL", "TPU.MESH.PIPE"):
        with pytest.raises(ValueError, match="one process"):
            InferenceEngine(_cfg(repo_root, axis, "2"), device="cpu")
