"""The ViT-L/14 32+64f slice on the CPU, at an L/14-shaped tiny geometry:
patch 14 with ``S_PATCH_SIZE 14`` and ``T_PATCH_SIZE 5`` (the temporal
stem's grid on the tower's token grid), every layer selected, heads of
64, 8 dense and 4 sparse frames at 56 px (4 x 4 + 1 tokens), narrow
widths.

- The port with ``TPU.REMAT`` against the JAX package with ``remat``, on
  tests/synth_ckpt.py weights carried across by ``state_dict_from_jax``:
  logits and dist_net gradients, fp32.
- The port's gradients with remat equal to those without, bit for bit
  (the TemporalNet fused, its kernels' plain versions on the CPU, and
  unfused).
- ``clip_dist_from_cfg`` on the L/14 configs against the JAX builder,
  field by field, on the meta device (no full-width weights made)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict
from dist_tpu.config import load_config as jax_load_config
from dist_tpu.models.clip.clip_video import CLIPDiSTModel as JaxCLIPDiSTModel
from dist_tpu.models.clip.clip_video import (
    clip_dist_from_cfg as jax_clip_dist_from_cfg,
)
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.clip.clip_video import (
    CLIPDiSTModel,
    clip_dist_from_cfg,
)
from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
from dist_tpu_torch.models.clip.model import sniff_architecture
from dist_tpu_torch.models.dist.dist_net import DiSTConfig

L14 = "configs/projects/dist/ssv2/vit-l14-32+64f.yaml"
L14_POD8 = "configs/projects/dist/ssv2/vit-l14-32+64f-pod8.yaml"

# 3 heads of 64, patch 14 at 56 px (a 4 x 4 grid), 2 layers, all selected
ARCH_KW = dict(embed_dim=32, image_resolution=56, vision_layers=2,
               vision_width=192, vision_patch_size=14, context_length=12,
               vocab_size=50, transformer_width=64, transformer_layers=1)
JAX_DIST = JaxDiSTConfig(
    selected_layers=(0, 1), temporal_dim=16, integration_dim=64,
    s_patch_size=14, t_patch_size=5, temporal_kernel_size=3,
    temporal_conv_mlp_ratio=1.0, integration_mlp_ratio=1.0,
    integration_temporal_mlp_ratio=0.25, ada_pooling_layers=2,
    num_frames=8, alpha=2)
DIST = DiSTConfig(**dataclasses.asdict(JAX_DIST))
B, CLASSES = 2, 5


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(14)
    sd = make_clip_state_dict(rng, **ARCH_KW)
    add_dist_state_dict(sd, rng, JAX_DIST, d_model=ARCH_KW["vision_width"])
    params, arch = convert_clip_params(sd, with_dist=JAX_DIST)
    return sd, params, arch


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(15)
    video = rng.standard_normal((B, JAX_DIST.num_frames, 56, 56, 3))
    text = rng.standard_normal((CLASSES, ARCH_KW["embed_dim"]))
    # the loss: a fixed random weighting of the logits
    weight = rng.standard_normal((B, 1, CLASSES))
    return tuple(a.astype(np.float32) for a in (video, text, weight))


def _port(sd, fused, remat):
    model = CLIPDiSTModel(sniff_architecture(sd), dist=DIST,
                          num_frames=DIST.num_frames,
                          sparse_alpha=DIST.alpha, fused_temporal=fused,
                          remat=remat)
    model.load_state_dict(to_torch(sd))
    return model.train()


def _port_grads(model, inputs):
    """(logits, {dist_net parameter: gradient}) of the weighted loss."""
    video, text, weight = (torch.from_numpy(a) for a in inputs)
    model.zero_grad(set_to_none=True)
    logits = model(video, text)["logits_per_image"]
    (logits * weight).sum().backward()
    # the last step's integration2temporal output reaches no loss: no
    # gradient here, zeros in JAX
    return logits.detach().numpy(), {
        k: (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        for k, p in model.named_parameters() if k.startswith("dist_net.")}


def test_remat_matches_jax(weights, inputs):
    """Logits and every dist_net gradient of the port with remat against
    the JAX package with remat, fp32, the TemporalNet fused as the L/14
    config runs it (on the CPU through the kernels' plain versions on the
    port's side). Both sides sum in fp32 in their own order through two
    tower layers and two ladder steps; read on the CPU: logits 1.4e-6 off
    (|logit| <= 3.1), each gradient 1.5e-6 of its tensor's largest value
    at worst. Limits: 1e-5 and 1e-5 of the largest value. A spatial tap
    dropped in the first TemporalNet moves the logits by 9.8e-5 and a
    gradient by 0.31 of its largest value."""
    sd, params, arch = weights
    video, text, weight = inputs
    jm = JaxCLIPDiSTModel(arch=arch, dist=JAX_DIST,
                          num_frames=JAX_DIST.num_frames,
                          sparse_alpha=JAX_DIST.alpha, fused_temporal=True,
                          remat=True)

    def loss(p):
        out = jm.apply({"params": p}, jnp.asarray(video), jnp.asarray(text))
        return (out["logits_per_image"] * weight).sum(), out[
            "logits_per_image"]

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    jgrads = state_dict_from_jax(jax.device_get(jgrads))

    logits, grads = _port_grads(_port(sd, True, remat=True), inputs)
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-5,
                               rtol=0)
    assert len(grads) > 100
    for k, g in grads.items():
        want = np.asarray(jgrads[k])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(g, want, atol=1e-5 * scale, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("fused", [True, False])
def test_remat_gradients_equal_without(weights, inputs, fused):
    """The ladder recomputed in the backward gives the gradients without
    remat bit for bit (fp32 on the CPU, same ops in the same order)."""
    sd, _, _ = weights
    plain = _port_grads(_port(sd, fused, remat=False), inputs)
    again = _port_grads(_port(sd, fused, remat=True), inputs)
    np.testing.assert_array_equal(again[0], plain[0])
    assert sorted(again[1]) == sorted(plain[1])
    for k in plain[1]:
        np.testing.assert_array_equal(again[1][k], plain[1][k], err_msg=k)


def test_remat_runs_each_step_again_in_the_backward(weights, inputs):
    """Under grad, remat runs each ladder step inside a checkpoint, which
    runs it again in the backward (last step first) instead of keeping its
    activations; under ``no_grad`` the steps run once."""
    sd, _, _ = weights
    video, text, _ = (torch.from_numpy(a) for a in inputs)
    calls = []
    model = _port(sd, fused=True, remat=True)
    step = model.dist_net._ladder_step
    model.dist_net._ladder_step = lambda *a: calls.append(a[0]) or step(*a)
    model(video, text)["logits_per_image"].sum().backward()
    # the forward, then each step again in the backward (last step first)
    assert calls == [0, 1, 1, 0]
    calls.clear()
    with torch.no_grad():
        model(video, text)
    assert calls == [0, 1]


@pytest.mark.parametrize("path", [L14, L14_POD8])
def test_l14_config_builds_as_jax(repo_root, path):
    """clip_dist_from_cfg on the L/14 configs: the same architecture,
    DiSTConfig, frames, freezing, precision and remat flag as the JAX
    builder; the port's model made on the meta device."""
    cfg = load_config(os.path.join(repo_root, path), make_output_dir=False)
    jcfg = jax_load_config(os.path.join(repo_root, path),
                           make_output_dir=False)
    with torch.device("meta"):
        got = clip_dist_from_cfg(cfg)
    want = jax_clip_dist_from_cfg(jcfg)
    assert dataclasses.asdict(got.visual.arch) == dataclasses.asdict(want.arch)
    assert dataclasses.asdict(got.dist) == dataclasses.asdict(want.dist)
    assert got.dist_net.remat == want.remat == (path == L14_POD8)
    assert (got.num_frames, got.sparse_alpha, got.freeze_visual,
            got.freeze_text, got.prediction_fusion) == (
        want.num_frames, want.sparse_alpha, want.freeze_visual,
        want.freeze_text, want.prediction_fusion)
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
    assert all(tn.fused == want.fused_temporal
               for tn in got.dist_net.temporal_nets)
    # the full width: 24 layers x 1024, 16 heads, 257 tokens, 24 ladder
    # steps over 64 dense and 32 sparse frames
    arch = got.visual.arch
    assert (arch.vision_layers, arch.vision_width, arch.vision_heads,
            arch.grid_size ** 2 + 1) == (24, 1024, 16, 257)
    assert (len(got.dist.selected_layers), got.dist.num_frames,
            got.dist.sparse_frames) == (24, 64, 32)
