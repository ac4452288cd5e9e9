"""The port's host transforms (``data/transforms.py``) against the JAX
package's. Crops, flips and resizes are equal bit for bit: the port
computes OpenCV's uint8 bilinear arithmetic (11-bit fixed-point weights)
in integers where the JAX package calls OpenCV. Colour jitter is numpy on
both sides: within 1 under the same generator."""

import numpy as np
import pytest

from dist_tpu.data import transforms as jt
from dist_tpu_torch.data import transforms as tt



def _clip(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _close_to_cv2(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("crops", [(1, 0), (3, 0), (3, 1), (3, 2)])
@pytest.mark.parametrize("hw", [(48, 80), (80, 48), (48, 48)])
def test_controlled_crop_matches_jax_bit_for_bit(hw, crops):
    frames = _clip((3,) + hw + (3,))
    num, idx = crops
    got = tt.kinetics_resized_crop_controlled(frames, 48, 32, num, idx)
    want = jt.kinetics_resized_crop_controlled(frames, 48, 32, num, idx)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["cc", "ll", "rr", "tl", "tr", "bl", "br"])
def test_flip_and_auto_crop_without_resize_match_jax(mode):
    frames = _clip((2, 40, 56, 3), seed=1)
    np.testing.assert_array_equal(tt.horizontal_flip(frames),
                                  jt.horizontal_flip(frames))
    got = tt.auto_resized_crop(frames, (40, 40), 32, mode)
    want = jt.auto_resized_crop(frames, (40, 40), 32, mode)
    assert got.shape == (2, 32, 32, 3)
    np.testing.assert_array_equal(got, want)
    rng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(
        tt.auto_resized_crop(frames, (40, 40), 32, "rand", rng),
        jt.auto_resized_crop(frames, (40, 40), 32, "rand", jrng))


@pytest.mark.parametrize("hw,side", [((240, 320), 224), ((360, 640), 256),
                                     ((100, 150), 64), ((256, 340), 224),
                                     ((320, 240), 112)])
def test_resize_short_side_close_to_opencv(hw, side):
    frames = _clip((4,) + hw + (3,), seed=side)
    _close_to_cv2(tt.resize_short_side(frames, side),
                  jt.resize_short_side(frames, side))
    assert tt.resize_short_side(frames, min(hw)) is frames


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_crops_close_to_opencv(seed):
    frames = _clip((3, 90, 120, 3), seed=seed)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    _close_to_cv2(
        tt.random_resized_crop(frames, 64, (0.08, 1.0), (0.75, 1.333), rng),
        jt.random_resized_crop(frames, 64, (0.08, 1.0), (0.75, 1.333), jrng))
    _close_to_cv2(tt.kinetics_resized_crop_random(frames, (64, 96), 56, rng),
                  jt.kinetics_resized_crop_random(frames, (64, 96), 56, jrng))
    # both generators drew the same numbers
    assert rng.uniform() == jrng.uniform()


@pytest.mark.parametrize("consistent", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_jitter_matches_jax(seed, consistent):
    frames = _clip((3, 16, 16, 3), seed=seed)
    kw = dict(brightness=0.4, contrast=0.4, saturation=0.2, hue=0.1,
              grayscale=0.5, consistent=consistent, shuffle=True,
              gray_first=bool(seed % 2), p=0.8)
    got = tt.color_jitter_clip(frames, np.random.default_rng(seed), **kw)
    want = jt.color_jitter_clip(frames, np.random.default_rng(seed), **kw)
    assert got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_gaussian_blur_waits_for_ssl():
    """The SSL blur is the JAX package's ``cv2.GaussianBlur`` blur bit
    for bit on the same draw (more sizes in
    ``tests/test_torch_port_ssl_data.py``)."""
    frames = _clip((2, 24, 30, 3))
    got = tt.gaussian_blur_clip(frames, np.random.default_rng(0))
    want = jt.gaussian_blur_clip(frames, np.random.default_rng(0))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, frames)
