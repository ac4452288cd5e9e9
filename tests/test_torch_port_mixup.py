"""The port's batch-mode Mixup/CutMix against the JAX package's
``mixup_batch``, on the CPU. The random streams of JAX and torch differ, so
each case takes JAX's own draws (the same ``jax.random`` calls as
``mixup_batch``) and hands them to the port's ``apply``."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.data import mixup as jmix
from dist_tpu_torch.config import load_config
from dist_tpu_torch.data import mixup

B, T, H, W = 4, 3, 14, 10
CLASSES = 7


def _jax_draw(key, mc, h, w):
    """mixup_batch's draws for ``key``, as the port's MixupDraw."""
    k_use, k_switch, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    use_mix = bool(jax.random.uniform(k_use) < mc.mix_prob)
    use_cutmix = bool(jax.random.uniform(k_switch) < mc.switch_prob)
    lam_mix = float(jax.random.beta(k_lam_m, mc.mixup_alpha, mc.mixup_alpha))
    if mc.cutmix_minmax is not None:
        kh, kw, ky, kx = jax.random.split(k_box, 4)
        lo, hi = mc.cutmix_minmax
        cut_h = int(jax.random.randint(kh, (), int(h * lo), int(h * hi)))
        cut_w = int(jax.random.randint(kw, (), int(w * lo), int(w * hi)))
        yl = int(jax.random.randint(ky, (), 0, h - cut_h))
        xl = int(jax.random.randint(kx, (), 0, w - cut_w))
        box = (yl, yl + cut_h, xl, xl + cut_w)
        lam_cut = float(np.float32(1.0) - np.float32(cut_h * cut_w)
                        / np.float32(h * w))
        jmask, jlam = jmix._rand_bbox_minmax_mask(k_box, h, w, mc.cutmix_minmax)
    else:
        lam = jax.random.beta(k_lam_c, mc.cutmix_alpha, mc.cutmix_alpha)
        ky, kx = jax.random.split(k_box)
        cy = int(jax.random.randint(ky, (), 0, h))
        cx = int(jax.random.randint(kx, (), 0, w))
        box, lam_cut = mixup.bbox_and_lam(h, w, float(lam), cy, cx)
        jmask, jlam = jmix._rand_bbox_mask(k_box, h, w, lam)
    # the port's box and lambda are JAX's
    mask = np.zeros((h, w), bool)
    mask[box[0]:box[1], box[2]:box[3]] = True
    np.testing.assert_array_equal(mask, np.asarray(jmask))
    assert lam_cut == float(jlam)
    return mixup.MixupDraw(use_mix, use_cutmix, lam_mix, lam_cut, box)


def _case(kind):
    """The first key whose draw is ``kind`` (mix_prob 0.6 so that some
    batches are not mixed)."""
    mc = jmix.MixupConfig(mixup_alpha=0.8, cutmix_alpha=1.0, mix_prob=0.6,
                          switch_prob=0.5, smoothing=0.1,
                          num_classes=CLASSES,
                          cutmix_minmax=(0.2, 0.8) if kind == "minmax"
                          else None)
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        d = _jax_draw(key, mc, H, W)
        got = ("none" if not d.use_mix else
               "cutmix" if d.use_cutmix else "mixup")
        if got == kind or (kind == "minmax" and got == "cutmix"):
            return key, mc, d
    raise AssertionError(f"no key draws {kind}")


@pytest.mark.parametrize("kind", ["mixup", "cutmix", "none", "minmax"])
def test_apply_matches_mixup_batch(kind):
    key, jmc, d = _case(kind)
    mc = mixup.MixupConfig(**dataclasses.asdict(jmc))
    rng = np.random.default_rng(1)
    video = rng.standard_normal((B, T, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, CLASSES, B)
    want_v, want_t = jmix.mixup_batch(key, jnp.asarray(video),
                                      jnp.asarray(labels), jmc)
    got_v, got_t = mixup.apply(torch.from_numpy(video),
                               torch.from_numpy(labels), d, mc)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_config_and_draws(repo_root):
    """MixupConfig.from_cfg equals the JAX package's on the flagship; the
    port's draws from a torch.Generator repeat with the seed and give a
    box inside the frame whose area matches the corrected lambda."""
    path = os.path.join(repo_root, "configs/projects/dist/ssv2/vit-b16-8+16f.yaml")
    mc = mixup.MixupConfig.from_cfg(load_config(path, make_output_dir=False))
    jmc = jmix.MixupConfig.from_cfg(jax_load_config(path,
                                                    make_output_dir=False))
    assert dataclasses.asdict(mc) == dataclasses.asdict(jmc)
    draws = [mixup.draw(mc, torch.Generator().manual_seed(s), 224, 224)
             for s in range(40)]
    assert draws[3] == mixup.draw(mc, torch.Generator().manual_seed(3), 224,
                                  224)
    assert {d.use_cutmix for d in draws} == {True, False}
    for d in draws:
        yl, yh, xl, xh = d.box
        assert 0 <= yl <= yh <= 224 and 0 <= xl <= xh <= 224
        assert d.lam_cut == pytest.approx(1 - (yh - yl) * (xh - xl) / 224 ** 2)
        assert 0.0 <= d.lam_mix <= 1.0
