"""The port's host resize (``data/transforms.py::_resize``), which computes
OpenCV's uint8 bilinear arithmetic in integers, against ``cv2.resize``
(``INTER_LINEAR``) and the JAX package's transforms: equal bit for bit at
the flagship's test scale, the train jitter sides, random-resized crops up
and down, an exact 2x downscale (which OpenCV runs as INTER_AREA) and odd
sizes."""

import cv2
import numpy as np
import pytest

from dist_tpu.data import transforms as jt
from dist_tpu_torch.data import transforms as tt


def _clip(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _cv2(frames, nh, nw):
    return np.stack([cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR)
                     .reshape(nh, nw, -1) for f in frames])


# (source (H, W), output (H, W), channels): the flagship's test scale (224
# short side) from common video sizes; an exact 2x downscale; odd sizes,
# one- and four-channel frames, single rows and columns, large up- and
# downscales
CASES = [((240, 320), (224, 298), 3), ((240, 427), (224, 398), 3),
         ((360, 640), (224, 398), 3), ((480, 854), (224, 398), 3),
         ((448, 448), (224, 224), 3), ((96, 130), (48, 65), 3),
         ((37, 53), (101, 77), 3), ((101, 77), (37, 53), 1),
         ((1, 9), (5, 13), 3), ((9, 1), (4, 3), 4), ((3, 3), (224, 224), 3),
         ((500, 333), (17, 29), 3)]


@pytest.mark.parametrize("src,dst,c", CASES)
def test_resize_equals_opencv(src, dst, c):
    frames = _clip((2,) + src + (c,), seed=src[0] * 1000 + dst[1])
    got = tt._resize(frames, *dst)
    assert got.dtype == np.uint8 and got.shape == (2,) + dst + (c,)
    np.testing.assert_array_equal(got, _cv2(frames, *dst))


@pytest.mark.parametrize("hw", [(240, 320), (240, 427), (360, 640),
                                (480, 854), (320, 240)])
def test_test_scale_resize_equals_jax(hw):
    """resize_short_side to the flagship's TEST_SCALE, 224."""
    frames = _clip((2,) + hw + (3,), seed=hw[1])
    np.testing.assert_array_equal(tt.resize_short_side(frames, 224),
                                  jt.resize_short_side(frames, 224))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_jitter_sides_equal_jax(seed):
    """kinetics_resized_crop_random over the base config's
    TRAIN_JITTER_SCALES [168, 224] sides, crop 112, from 240 x 320."""
    frames = _clip((2, 240, 320, 3), seed=seed)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(
            tt.kinetics_resized_crop_random(frames, (168, 224), 112, rng),
            jt.kinetics_resized_crop_random(frames, (168, 224), 112, jrng))


@pytest.mark.parametrize("hw,scale", [((240, 320), (0.08, 0.2)),
                                      ((240, 320), (0.4, 1.0)),
                                      ((480, 854), (0.4, 1.0))])
def test_random_resized_crops_equal_jax(hw, scale):
    """random_resized_crop to 224: small crops scaled up, 480-row crops
    scaled down (the SSV2 configs' TRAIN_JITTER_SCALES [0.08, 1.0] and
    [0.4, 1.0])."""
    frames = _clip((2,) + hw + (3,), seed=hw[0] + int(10 * scale[0]))
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(3):
        np.testing.assert_array_equal(
            tt.random_resized_crop(frames, 224, scale, (0.75, 1.333), rng),
            jt.random_resized_crop(frames, 224, scale, (0.75, 1.333), jrng))
