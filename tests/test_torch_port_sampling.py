"""The port's frame-index sampling (``data/sampling.py``) against the JAX
package's: the same indices, exactly, for both modes over video lengths
1-300, frame rates 15/30/60 and clip indices -1 (random) to 9, with the
same seeded numpy generator on both sides."""

import os

import numpy as np
import pytest

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import sampling as jax_sampling
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import sampling

TINY = "configs/projects/dist/test/tiny_synth.yaml"


@pytest.mark.parametrize("fps", [15.0, 30.0, 60.0])
@pytest.mark.parametrize("mode", ["interval_based", "segment_based"])
def test_frame_indices_match_jax(repo_root, mode, fps):
    opts = ["DATA.SAMPLING_MODE", mode, "DATA.NUM_INPUT_FRAMES", "8"]
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, opts, make_output_dir=False)
    jcfg = jax_load_config(path, opts, make_output_dir=False)
    for num_clips in (1, 10):
        rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
        for length in range(1, 301):
            for clip_idx in range(-1, 10):
                random = clip_idx == -1
                got = sampling.get_frame_indices(
                    cfg, length, fps, clip_idx, num_clips, rng=rng,
                    random_sample=random)
                want = jax_sampling.get_frame_indices(
                    jcfg, length, fps, clip_idx, num_clips, rng=jrng,
                    random_sample=random)
                np.testing.assert_array_equal(got, want)
                assert got.dtype == np.int64


def test_single_frame_and_unknown_mode(repo_root):
    path = os.path.join(repo_root, TINY)
    cfg = load_config(path, ["DATA.NUM_INPUT_FRAMES", "1"],
                      make_output_dir=False)
    got = sampling.interval_based_sampling(
        50, 30.0, 0, 1, 1, 4, rng=np.random.default_rng(3))
    want = jax_sampling.interval_based_sampling(
        50, 30.0, 0, 1, 1, 4, rng=np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)
    cfg.DATA.SAMPLING_MODE = "nope"
    with pytest.raises(NotImplementedError):
        sampling.get_frame_indices(cfg, 10, 30.0, 0, 1)
