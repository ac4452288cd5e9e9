"""The port's ``Loader`` against the JAX package's: the same index stream,
per-sample seeds, final-batch padding, ``_mask`` and resume skip, for
shuffle on and off, 1-4 folds and process counts 1 and 2; and on
``tiny_synth.yaml`` the same batches as the JAX loader, bit for bit on
every split (the train split resizes in its random crop, as OpenCV
does)."""

import os

import numpy as np
import pytest

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import builder as jax_builder
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import builder

TINY = "configs/projects/dist/test/tiny_synth.yaml"


class _Items:
    """A dataset whose items record the index and seed they were asked
    for."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, index, seed=None):
        return {"video": np.full((2, 2), index, np.uint8),
                "index": np.int64(index), "seed": np.int64(seed)}


def _batches(loader, epoch, skip):
    loader.set_epoch(epoch)
    loader.set_skip_batches(skip)
    return list(loader)


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("procs", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("folds", [1, 2, 3, 4])
@pytest.mark.parametrize("shuffle", [False, True])
def test_stream_matches_jax(shuffle, folds, procs, drop_last):
    count, index = procs
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=2, seed=3, num_folds=folds, process_index=index,
              process_count=count, prefetch=2)
    got = builder.Loader(_Items(11), **kw)
    want = jax_builder.Loader(_Items(11), **kw)
    assert len(got) == len(want)
    for epoch, skip in ((0, 0), (1, 0), (1, min(1, len(got) - 1))):
        _assert_same(_batches(got, epoch, skip), _batches(want, epoch, skip))
    with pytest.raises(ValueError, match="geometry changed"):
        _batches(got, 0, len(got))


def test_abandoned_iteration_stops_on_close():
    loader = builder.Loader(_Items(40), 2, False, False, num_workers=2,
                            prefetch=1)
    it = iter(loader)
    next(it)
    assert len(loader._stops) == 1
    loader.close()
    assert all(stop.is_set() for stop in loader._stops)


@pytest.mark.parametrize("split", ["test", "val", "train"])
def test_tiny_synth_batches_match_jax(repo_root, split):
    """The JAX loader's batch is the per-device batch (1) times the 8
    virtual devices; the port's is the config's, set to 8 here."""
    path = os.path.join(repo_root, TINY)
    common = ["TEST.NUM_ENSEMBLE_VIEWS", "3", "TEST.NUM_SPATIAL_CROPS", "3",
              "TRAIN.NUM_SAMPLES_LIMIT", "12"]
    cfg = load_config(path, common + ["TEST.BATCH_SIZE", "8",
                                      "TRAIN.BATCH_SIZE", "8"],
                      make_output_dir=False)
    jcfg = jax_load_config(path, common, make_output_dir=False)
    got = builder.build_loader(cfg, split, device="cpu")
    want = jax_builder.build_loader(jcfg, split)
    assert (got.batch_size, len(got)) == (want.batch_size, len(want))
    gb, wb = list(got), list(want)
    assert len(gb) == len(wb) > 0
    for g, w in zip(gb, wb):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_process_pool_is_not_ported(repo_root):
    """The process pool is ported (ROADMAP.md queue A, item 3): under
    ``DATA_LOADER.WORKER_TYPE: process`` the test split's loader, its
    workers spawned, yields the thread pool's batches bit for bit, and
    ``close`` shuts its workers down."""
    opts = ["TEST.NUM_SAMPLES_LIMIT", "3", "TEST.BATCH_SIZE", "2"]
    thread = builder.build_loader(
        load_config(os.path.join(repo_root, TINY), opts,
                    make_output_dir=False), "test", device="cpu")
    cfg = load_config(os.path.join(repo_root, TINY),
                      opts + ["DATA_LOADER.WORKER_TYPE", "process"],
                      make_output_dir=False)
    loader = builder.build_loader(cfg, "test", device="cpu")
    try:
        got, want = list(loader), list(thread)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert loader._proc_pool is not None
    finally:
        loader.close()
    assert loader._proc_pool is None
