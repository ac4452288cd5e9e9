"""The port's RandAugment, AutoAugment, AugMix and random erasing
(``dist_tpu_torch/data/rand_augment.py``) against the JAX package's
(``dist_tpu/data/rand_augment.py``) and its OpenCV twins against OpenCV,
on the CPU, on seeded uint8 clips. Every comparison is bit for bit (no
tolerance):

- each op of the op table at four levels (the random sign from the same
  ``Generator``), on an odd-sized and an even-sized clip;
- each policy (RandAugment's three recipes, the four AutoAugment tables
  with and without a magnitude spread, AugMix) over several seeds;
- ``RandomErasing`` in its ``const``, ``rand`` and ``pixel`` modes;
- the twins against ``cv2`` directly: ``equalizeHist``,
  ``getRotationMatrix2D``, ``warpAffine`` (``INTER_LINEAR``, constant 0
  border) at the levels the policies reach on widths below, at and past
  OpenCV's vector step, and ``GaussianBlur`` at sigma 0, whose kernel
  was OpenCV's sigma formula before its fixed tables (the old kernel is
  shown to fail)."""

import cv2
import numpy as np
import pytest

from dist_tpu.data import rand_augment as jax_ra
from dist_tpu_torch.data import rand_augment as ra
from dist_tpu_torch.data import transforms

OPS = sorted(ra._OPS)
LEVELS = (0.0, 3.7, 9.0, 10.0)
SHAPES = ((2, 37, 41, 3), (2, 32, 48, 3))
POLICIES = ("rand-m9-mstd0.5-inc1", "rand-m7-n4-mstd0.5", "rand-m9-n3-mstd0-inc0",
            "v0", "v0r", "original", "originalr", "v0-mstd0.5",
            "originalr-mstd0.5", "augmix-m5-w4-d2", "augmix-m3-w3-a0.5")


def _clip(seed, shape, levels=256):
    """A seeded uint8 clip; ``levels`` < 256 leaves few distinct values
    (so equalisation has empty bins and ties)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, levels, shape, dtype=np.uint8)
    return (x * (255 // max(levels - 1, 1))).astype(np.uint8)


def test_the_op_tables_match_jax():
    assert sorted(ra._OPS) == sorted(jax_ra._OPS)
    assert ra._RAND_INCREASING == jax_ra._RAND_INCREASING
    assert ra._RAND_DEFAULT == jax_ra._RAND_DEFAULT
    assert ra._AUGMIX_TRANSFORMS == jax_ra._AUGMIX_TRANSFORMS
    assert ra._POLICIES == jax_ra._POLICIES


@pytest.mark.parametrize("name", OPS)
def test_each_op_matches_jax(name):
    for s, shape in enumerate(SHAPES):
        x = _clip(s, shape, levels=256 if s else 9)
        for i, level in enumerate(LEVELS):
            seed = 100 * s + i
            want = jax_ra.apply_op(name, x, level, np.random.default_rng(seed))
            got = ra.apply_op(name, x, level, np.random.default_rng(seed))
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{shape} level {level}")


@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_matches_jax(policy):
    """Same seed, same clip: the same ops drawn and the same uint8
    result, the generators left in the same state."""
    port = ra.create_auto_augmentation(policy, 40)
    jax = jax_ra.create_auto_augmentation(policy, 40)
    assert type(port).__name__ == type(jax).__name__
    x = _clip(1, (3, 40, 44, 3))
    for seed in range(6):
        g, w = np.random.default_rng(seed), np.random.default_rng(seed)
        np.testing.assert_array_equal(port(x, g), jax(x, w),
                                      err_msg=f"seed {seed}")
        assert g.uniform() == w.uniform()


@pytest.mark.parametrize("mode", ["const", "rand", "pixel"])
def test_random_erasing_matches_jax(mode):
    x = _clip(2, (3, 33, 40, 3))
    kw = dict(prob=0.9, mode=mode, count=(1, 3), area_range=(0.02, 0.33),
              min_aspect=0.3)
    port, jax = ra.RandomErasing(**kw), jax_ra.RandomErasing(**kw)
    erased = 0
    for seed in range(6):
        g, w = np.random.default_rng(seed), np.random.default_rng(seed)
        got = port(x, g)
        np.testing.assert_array_equal(got, jax(x, w), err_msg=f"seed {seed}")
        erased += int(not np.array_equal(got, x))
    assert erased > 0


@pytest.mark.parametrize("levels", [256, 5, 1], ids=["full", "few", "one"])
def test_equalize_hist_twin_matches_cv2(levels):
    x = _clip(3, (3, 29, 35, 3), levels)
    want = np.stack([np.stack([cv2.equalizeHist(f[..., c]) for c in range(3)],
                              -1) for f in x])
    np.testing.assert_array_equal(ra._equalize_hist(x), want)


def test_rotation_matrix_twin_matches_cv2():
    for w, h in ((41, 37), (48, 32), (112, 112)):
        for deg in (-30.0, -7.31, 0.0, 12.5, 27.0):
            np.testing.assert_array_equal(
                ra._rotation_matrix(w / 2, h / 2, deg),
                cv2.getRotationMatrix2D((w / 2, h / 2), deg, 1.0))


def _matrices(w, h, frac):
    """The policies' warp maps at a fraction of their largest level."""
    return {"rotate": cv2.getRotationMatrix2D((w / 2, h / 2), 30 * frac, 1.0),
            "shear_x": np.float32([[1, 0.3 * frac, 0], [0, 1, 0]]),
            "shear_y": np.float32([[1, 0, 0], [0.3 * frac, 1, 0]]),
            "translate_x": np.float32([[1, 0, 0.45 * frac * w], [0, 1, 0]]),
            "translate_y": np.float32([[1, 0, 0], [0, 1, 0.45 * frac * h]])}


@pytest.mark.parametrize("w", [7, 16, 33, 47, 112])
def test_warp_affine_twin_matches_cv2(w):
    """Widths below one vector step of OpenCV's loop, at one, and with a
    scalar tail; odd and even heights; both signs."""
    for h in (15, 32):
        x = _clip(w + h, (2, h, w, 3))
        for frac in (-1.0, -0.61, 0.05, 0.37, 0.9):
            for kind, m in _matrices(w, h, frac).items():
                want = np.stack([cv2.warpAffine(f, m, (w, h)) for f in x])
                np.testing.assert_array_equal(
                    ra._warp_affine(x, m), want,
                    err_msg=f"{kind} {frac} at {h} x {w}")


def test_blur_at_sigma_zero_matches_cv2_and_the_old_kernel_did_not():
    """``_blur_frames(x, k, 0)`` equals ``cv2.GaussianBlur(x, (k, k), 0)``
    for k = 1, 3, 5, 7: OpenCV's fixed tables (for 3: [64, 128, 64] /
    256). The kernel before them, OpenCV's sigma formula ``0.15 k +
    0.35`` at k = 3 ([61, 134, 61]), differs from OpenCV on most values;
    sigma > 0 keeps that formula's path."""
    x = _clip(4, (2, 37, 41, 3))
    for k in (1, 3, 5, 7):
        want = np.stack([cv2.GaussianBlur(f, (k, k), 0) for f in x])
        np.testing.assert_array_equal(transforms._blur_frames(x, k, 0), want,
                                      err_msg=f"k {k}")
    np.testing.assert_array_equal(transforms._gaussian_kernel(3, 0),
                                  [64, 128, 64])
    old = transforms._blur_frames(x, 3, 0.15 * 3 + 0.35)
    np.testing.assert_array_equal(transforms._gaussian_kernel(3, 0.8),
                                  [61, 134, 61])
    want = np.stack([cv2.GaussianBlur(f, (3, 3), 0) for f in x])
    assert (old != want).mean() > 0.5
    for sigma in (0.1, 0.8, 1.7):
        want = np.stack([cv2.GaussianBlur(f, (5, 5), sigma) for f in x])
        np.testing.assert_array_equal(transforms._blur_frames(x, 5, sigma),
                                      want, err_msg=f"sigma {sigma}")
