"""The port's device augmentation (``dist_tpu_torch/ops/augment_device.py``,
``AUGMENTATION.USE_GPU``) against the JAX package's
(``dist_tpu/ops/augment_device.py``), fp32 on the CPU:

- the apply: the test replays the JAX function's own ``jax.random``
  draws from the same key (its splits: flip, then the jitter's per-row
  keys, then the blur's) and feeds those factors to the port's
  ``apply``; the outputs of the whole chain and of each op at
  ``atol=1e-5`` (values in [0, 1]), for the SimCLR recipe (hue,
  grayscale, blur), a jitter without hue, and a blur alone;
- the HSV helpers against the JAX package's, gray pixels included
  (``atol=1e-6``);
- ``from_cfg``'s gates: every field equal to the JAX package's for the
  SSL gate, ``COLOR_AUG`` on and off, AutoAugment in its place, and
  SSV2 (no flip);
- the draws: a pure function of the generator's seed, one entry a row,
  each in its range; ``augment_draws`` at world 1 is the draw itself;
- on a flattened 6-D SSL batch the flip reverses W, not H."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.data import transforms as jt
from dist_tpu.ops import augment_device as ja
from dist_tpu_torch.config import load_config
from dist_tpu_torch.ops import augment_device as pa
from dist_tpu_torch.tasks.state import augment_draws, step_generator
from tests.test_torch_port_resnet3d import cfgs

TOL = dict(atol=1e-5, rtol=0)
CASES = {
    "simclr": dict(brightness=0.8, contrast=0.8, saturation=0.8, hue=0.2,
                   grayscale=0.2, color_p=0.8, blur_p=0.5, flip=0.5),
    "no-hue": dict(brightness=0.4, contrast=0.4, saturation=0.2,
                   grayscale=0.3, color_p=0.7, flip=0.5),
    "blur": dict(color_p=0.0, blur_p=0.7, flip=0.5, blur_sigma=1.5),
}
SHAPE = (8, 3, 40, 40, 3)


def replay_draws(key, rows, c):
    """The factors ``dist_tpu.ops.augment_device.device_augment`` draws
    from ``key`` for ``rows`` rows, as the port's ``draw`` names them."""
    k1, k2, k3 = jax.random.split(key, 3)
    out = {"flip": jax.random.uniform(k1, (rows, 1, 1, 1, 1)).reshape(rows)
           < c.flip}
    if c.jitter:
        def row(key_row):
            k = jax.random.split(key_row, 6)
            u = jax.random.uniform
            return {"color": u(k[0]) < c.color_p,
                    "brightness": u(k[1], minval=max(0, 1 - c.brightness),
                                    maxval=1 + c.brightness),
                    "contrast": u(k[2], minval=max(0, 1 - c.contrast),
                                  maxval=1 + c.contrast),
                    "saturation": u(k[3], minval=max(0, 1 - c.saturation),
                                    maxval=1 + c.saturation),
                    "hue": u(k[4], minval=-c.hue, maxval=c.hue),
                    "gray": u(k[5]) < c.grayscale}
        out.update(jax.vmap(row)(jax.random.split(k2, rows)))
    if c.blur_p > 0:
        def blur_row(key_row):
            a, b = jax.random.split(key_row)
            return {"sigma": jax.random.uniform(
                        a, minval=0.1, maxval=2.0 * c.blur_sigma),
                    "blur": jax.random.uniform(b) < c.blur_p}
        out.update(jax.vmap(blur_row)(jax.random.split(k3, rows)))
    return {k: torch.from_numpy(np.asarray(v)) for k, v in out.items()}


def _video(seed):
    return np.random.default_rng(seed).uniform(0, 1, SHAPE).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_matches_jax_on_its_own_draws(case):
    jc = ja.DeviceAugConfig(**CASES[case])
    pc = pa.DeviceAugConfig(**CASES[case])
    assert pc.jitter == bool(jc.brightness or jc.contrast or jc.saturation
                             or jc.hue or jc.grayscale)
    video = _video(100 + len(case))
    key = jax.random.PRNGKey(7)
    f = replay_draws(key, SHAPE[0], pc)
    # the draws hit both branches of every gate
    for gate in ("flip", "color", "gray", "blur"):
        if gate in f and gate != "gray":
            assert 0 < int(f[gate].sum()) < SHAPE[0], gate
    want = np.asarray(jax.jit(lambda k, v: ja.device_augment(k, v, jc))(
        key, jnp.asarray(video)))
    got = pa.apply(torch.from_numpy(video), f, pc).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert not np.allclose(got, video)

    # each op alone on the same factors
    k1, k2, k3 = jax.random.split(key, 3)
    flipped = pa.apply_hflip(torch.from_numpy(video), f["flip"])
    np.testing.assert_array_equal(
        flipped.numpy(), np.asarray(ja.random_hflip(k1, jnp.asarray(video),
                                                    jc.flip)))
    if pc.jitter:
        np.testing.assert_allclose(
            pa.apply_color_jitter(torch.from_numpy(video), f, pc).numpy(),
            np.asarray(jax.jit(lambda k, v: ja.color_jitter(k, v, jc))(
                k2, jnp.asarray(video))), **TOL)
    if pc.blur_p:
        np.testing.assert_allclose(
            pa.apply_gaussian_blur(torch.from_numpy(video), f, pc).numpy(),
            np.asarray(jax.jit(lambda k, v: ja.gaussian_blur(k, v, jc))(
                k3, jnp.asarray(video))), **TOL)


def test_hsv_helpers_match_jax():
    rng = np.random.default_rng(110)
    x = rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
    x[0, 0, :4] = 0.5                       # gray: max == min
    x[1, 1, :4] = [1.0, 1.0, 0.0]           # two channels tied at the max
    x[2, 2, :4] = [0.0, 0.3, 1.0]
    jh, js, jv = jt._rgb2hsv(jnp.asarray(x), xp=jnp)
    ph, ps, pv = pa.rgb2hsv(torch.from_numpy(x))
    for got, want in ((ph, jh), (ps, js), (pv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    shift = 0.37
    want = np.asarray(jt._hsv2rgb(jnp.mod(jh + shift, 1.0), js, jv, xp=jnp))
    got = pa.hsv2rgb(torch.remainder(ph + shift, 1.0), ps, pv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the round trip without a shift gives the pixels back
    np.testing.assert_allclose(pa.hsv2rgb(ph, ps, pv).numpy(), x, atol=1e-6)


GATES = {
    "ssl": ("configs/projects/hico/simclr_k400_s3dg.yaml", []),
    "color_aug_off": ("configs/projects/dist/test/tiny_synth.yaml",
                      ["AUGMENTATION.COLOR_AUG", "false",
                       "AUGMENTATION.BRIGHTNESS", "0.4"]),
    "color_aug_on": ("configs/projects/dist/test/tiny_synth.yaml",
                     ["AUGMENTATION.COLOR_AUG", "true",
                      "AUGMENTATION.BRIGHTNESS", "0.4",
                      "AUGMENTATION.GRAYSCALE", "0.2",
                      "AUGMENTATION.COLOR_JITTER_P", "0.6"]),
    "autoaugment": ("configs/projects/dist/test/tiny_synth.yaml",
                    ["AUGMENTATION.COLOR_AUG", "true",
                     "AUGMENTATION.AUTOAUGMENT.ENABLE", "true"]),
    "ssv2": ("configs/projects/dist/ssv2/vit-b16-8+16f.yaml", []),
}


@pytest.mark.parametrize("case", list(GATES))
def test_from_cfg_gates_match_jax(repo_root, case):
    path, opts = GATES[case]
    cfg, jcfg = cfgs(repo_root, path, opts)
    got = dataclasses.asdict(pa.DeviceAugConfig.from_cfg(cfg))
    assert got == dataclasses.asdict(ja.DeviceAugConfig.from_cfg(jcfg))
    if case == "ssl":
        assert got["color_p"] == 0.8 and got["blur_p"] == 0.5
        assert got["hue"] == 0.2 and got["flip"] == 0.5
    if case == "ssv2":
        assert got["flip"] == 0.0
    if case in ("color_aug_off", "autoaugment"):
        assert got["color_p"] == 0.0 and got["brightness"] == 0.0


def test_draws_are_a_function_of_the_seed(repo_root):
    cfg = load_config(os.path.join(
        repo_root, "configs/projects/hico/simclr_k400_s3dg.yaml"),
        make_output_dir=False)
    c = pa.DeviceAugConfig.from_cfg(cfg)
    a = pa.draw(c, 16, step_generator(5, 3))
    b = pa.draw(c, 16, step_generator(5, 3))
    other = pa.draw(c, 16, step_generator(5, 4))
    assert set(a) == {"flip", "color", "brightness", "contrast",
                      "saturation", "hue", "gray", "sigma", "blur"}
    for k in a:
        assert a[k].shape == (16,) and torch.equal(a[k], b[k]), k
    assert not torch.equal(a["brightness"], other["brightness"])
    assert float(a["brightness"].min()) >= 0.2
    assert float(a["brightness"].max()) <= 1.8
    assert float(a["hue"].abs().max()) <= 0.2
    assert 0.1 <= float(a["sigma"].min()) and float(a["sigma"].max()) <= 2.0
    # world 1: the rank's slice is the whole draw
    world1 = augment_draws(c, 16, 5, 3)
    for k in a:
        assert torch.equal(world1[k], a[k]), k


def test_flip_of_a_flattened_ssl_batch_reverses_width():
    video = torch.zeros(2, 2, 2, 4, 6, 3)
    video[..., :, :3, :] = 1.0               # the left half of the width
    flat = video.reshape((-1,) + tuple(video.shape[2:]))
    out = pa.apply_hflip(flat, torch.ones(4, dtype=torch.bool))
    assert bool((out[..., :, 3:, :] == 1.0).all())
    assert bool((out[..., :, :3, :] == 0.0).all())
