"""The port's test meters and metric functions against the JAX
package's: ``TestMeter`` and ``EpicKitchenMeter`` on seeded per-clip
scores with padded duplicate views, for the ``sum`` and ``max``
ensembles; ``topk_errors``, ``topk_accuracies`` and
``joint_topks_correct`` on the same scores."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dist_tpu.utils import meters as jax_meters
from dist_tpu.utils import metrics as jax_metrics
from dist_tpu_torch.config import load_config
from dist_tpu_torch.utils import meters, metrics

TINY = "configs/projects/dist/test/tiny_synth.yaml"
VIDEOS, VIEWS = 7, 3


def _stream(classes, seed):
    """Batches of 4 (scores, labels, clip ids) over every view of every
    video in order, the final batch padded by cycling the first ids, as
    the loader does."""
    rng = np.random.default_rng(seed)
    ids = np.arange(VIDEOS * VIEWS)
    ids = np.concatenate([ids, ids[:(-len(ids)) % 4]])
    labels = rng.integers(0, 5, VIDEOS)
    out = []
    for s in range(0, len(ids), 4):
        cid = ids[s:s + 4]
        scores = rng.random((len(cid),) + classes).astype(np.float32)
        out.append((scores, labels[cid // VIEWS], cid))
    return out


@pytest.mark.parametrize("method", ["sum", "max"])
def test_test_meter_matches_jax(repo_root, method):
    cfg = load_config(os.path.join(repo_root, TINY), make_output_dir=False)
    got = meters.TestMeter(VIDEOS, VIEWS, 12, cfg, ensemble_method=method)
    want = jax_meters.TestMeter(VIDEOS, VIEWS, 12, cfg,
                                ensemble_method=method)
    for scores, labels, ids in _stream((12,), seed=1):
        got.update_stats(scores, labels, ids)
        want.update_stats(scores, labels, ids)
    np.testing.assert_array_equal(got.video_preds, want.video_preds)
    np.testing.assert_array_equal(got.video_labels, want.video_labels)
    np.testing.assert_array_equal(got.clip_count, [VIEWS] * VIDEOS)
    assert got.finalize_metrics() == want.finalize_metrics()
    got.reset()
    assert not got.video_preds.any() and not got.clip_count.any()


def test_test_meter_refuses_a_label_mismatch(repo_root):
    cfg = load_config(os.path.join(repo_root, TINY), make_output_dir=False)
    m = meters.TestMeter(2, 2, 3, cfg)
    m.update_stats(np.ones((1, 3)), [1], [0])
    with pytest.raises(ValueError, match="label mismatch"):
        m.update_stats(np.ones((1, 3)), [2], [1])


@pytest.mark.parametrize("method", ["sum", "max"])
def test_epic_meter_matches_jax(repo_root, method):
    cfg = load_config(os.path.join(repo_root, TINY), make_output_dir=False)
    nc = (4, 6)
    got = meters.EpicKitchenMeter(VIDEOS, VIEWS, nc, cfg,
                                  ensemble_method=method)
    want = jax_meters.EpicKitchenMeter(VIDEOS, VIEWS, nc, cfg,
                                       ensemble_method=method)
    verb = _stream((nc[0],), seed=2)
    noun = _stream((nc[1],), seed=3)
    for (v, vl, ids), (n, nl, _) in zip(verb, noun):
        preds = {"verb_class": v, "noun_class": n}
        labels = {"verb_class": vl % nc[0], "noun_class": nl % nc[1]}
        got.update_stats(preds, labels, ids)
        want.update_stats(preds, labels, ids)
    for key in want.video_preds:
        np.testing.assert_array_equal(got.video_preds[key],
                                      want.video_preds[key])
    for key in want.video_labels:
        np.testing.assert_array_equal(got.video_labels[key],
                                      want.video_labels[key])
    np.testing.assert_array_equal(got.clip_count, [VIEWS] * VIDEOS)
    assert got.finalize_metrics() == want.finalize_metrics()


@pytest.mark.parametrize("classes", [3, 12])
def test_topk_functions_match_jax(classes):
    rng = np.random.default_rng(classes)
    preds = rng.random((9, classes)).astype(np.float32)
    labels = rng.integers(0, classes, 9)
    tp, tl = torch.from_numpy(preds), torch.from_numpy(labels)
    jp, jl = jnp.asarray(preds), jnp.asarray(labels)
    # counts of whole samples: equal up to float32 division
    for fn in ("topk_errors", "topk_accuracies"):
        got = getattr(metrics, fn)(tp, tl, (1, 5))
        want = getattr(jax_metrics, fn)(jp, jl, (1, 5))
        np.testing.assert_allclose([float(g) for g in got],
                                   [float(w) for w in want], rtol=1e-6)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_joint_topks_correct_matches_jax(normalized, weighted):
    rng = np.random.default_rng(int(normalized) * 2 + int(weighted))
    n, nv, nn = 10, 4, 6
    verb = rng.random((n, nv)).astype(np.float32)
    noun = rng.random((n, nn)).astype(np.float32)
    vl, nl = rng.integers(0, nv, n), rng.integers(0, nn, n)
    w = (rng.random(n) > 0.3).astype(np.float32) if weighted else None
    got = metrics.joint_topks_correct(
        *(torch.from_numpy(a) for a in (verb, noun, vl, nl)), (1, 5),
        normalized=normalized,
        weights=None if w is None else torch.from_numpy(w))
    want = jax_metrics.joint_topks_correct(
        *(jnp.asarray(a) for a in (verb, noun, vl, nl)), (1, 5),
        normalized=normalized, weights=None if w is None else jnp.asarray(w))
    assert sorted(got) == sorted(want)
    for k in want:   # counts of (weighted) samples: exact
        assert float(got[k]) == float(want[k]), k
