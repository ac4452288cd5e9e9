"""The port's whole CLIP+DiST model against the JAX package's, at the tiny
geometry of tests/test_clip_parity.py, on tests/synth_ckpt.py weights
brought over with ``state_dict_from_jax``; plus the weight round trip and
the torch goldens of tests/torch_golden.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tests.torch_golden as G
from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict
from dist_tpu.models.clip.clip_video import CLIPDiSTModel as JaxCLIPDiSTModel
from dist_tpu.models.clip.convert import convert_clip_params
from dist_tpu.models.dist.dist_net import DiSTConfig as JaxDiSTConfig
from dist_tpu_torch.models.clip.clip_video import CLIPDiSTModel
from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
from dist_tpu_torch.models.clip.model import sniff_architecture
from dist_tpu_torch.models.dist.dist_net import DiSTConfig

ARCH_KW = dict(embed_dim=32, image_resolution=32, vision_layers=2,
               vision_width=64, vision_patch_size=16, context_length=12,
               vocab_size=50, transformer_width=64, transformer_layers=2)
JAX_DIST = JaxDiSTConfig(
    selected_layers=(0, 1), temporal_dim=16, integration_dim=64,
    s_patch_size=16, t_patch_size=5, temporal_kernel_size=3,
    temporal_conv_mlp_ratio=1.0, integration_mlp_ratio=1.0,
    integration_temporal_mlp_ratio=0.25, ada_pooling_layers=2,
    num_frames=4, alpha=2)
DIST = DiSTConfig(**dataclasses.asdict(JAX_DIST))
B, T = 2, 4


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    sd = make_clip_state_dict(rng, **ARCH_KW)
    add_dist_state_dict(sd, rng, JAX_DIST, d_model=ARCH_KW["vision_width"])
    params, arch = convert_clip_params(sd, with_dist=JAX_DIST)
    return sd, params, arch


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    video = rng.standard_normal((B, T, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((5, ARCH_KW["context_length"]), np.int64)
    for row in range(5):
        n = 3 + row
        tokens[row, :n] = rng.integers(1, ARCH_KW["vocab_size"] - 1, n)
        tokens[row, n - 1] = ARCH_KW["vocab_size"] - 1   # eot = highest id
    return video, tokens


def test_state_dict_round_trip_is_exact(weights):
    """synth state dict -> convert_clip_params/convert_dist_net ->
    state_dict_from_jax gives back the same keys and arrays, bit for bit."""
    sd, params, _ = weights
    back = state_dict_from_jax(params)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_state_dict_keys_are_the_modules(weights):
    sd, _, _ = weights
    model = CLIPDiSTModel(sniff_architecture(sd), dist=DIST, num_frames=T,
                          sparse_alpha=DIST.alpha)
    own = model.state_dict()
    assert sorted(own) == sorted(sd)
    for k, v in sd.items():
        assert tuple(own[k].shape) == np.shape(v), k


def _port(sd, fused, dtype=torch.float32):
    model = CLIPDiSTModel(sniff_architecture(sd), dist=DIST, num_frames=T,
                          sparse_alpha=DIST.alpha, fused_temporal=fused,
                          dtype=dtype)
    model.load_state_dict(to_torch(state_dict_from_jax(
        convert_clip_params(sd, with_dist=JAX_DIST)[0])))
    return model.eval()


def _jax(arch, fused, dtype=jnp.float32):
    return JaxCLIPDiSTModel(arch=arch, dist=JAX_DIST, num_frames=T,
                            sparse_alpha=JAX_DIST.alpha,
                            fused_temporal=fused, dtype=dtype)


@pytest.mark.parametrize("fused", [False, True])
def test_whole_model_matches_jax(weights, inputs, fused):
    """Per-layer taps, text features, video embedding and logits, fp32."""
    sd, params, arch = weights
    video, tokens = inputs
    jm = _jax(arch, fused)
    jtf = jm.apply({"params": params}, jnp.asarray(tokens, jnp.int32),
                   method=JaxCLIPDiSTModel.encode_text)
    jout = jm.apply({"params": params}, jnp.asarray(video), jtf)
    _, _, jtaps = jm.apply({"params": params}, jnp.asarray(video),
                           method=lambda m, v: m.visual(v))

    pm = _port(sd, fused)
    with torch.no_grad():
        ptf = pm.encode_text(torch.from_numpy(tokens))
        pout = pm(torch.from_numpy(video), ptf)
        _, _, ptaps = pm.visual(torch.from_numpy(video))
    # fp32 through ~30 ops on both sides; only summation order differs
    tol = dict(atol=1e-4, rtol=0)
    for i in range(arch.vision_layers):
        np.testing.assert_allclose(ptaps[i].numpy(), np.asarray(jtaps[i]),
                                   err_msg=f"tap {i}", **tol)
    np.testing.assert_allclose(ptf.numpy(), np.asarray(jtf), **tol)
    np.testing.assert_allclose(pout["vid_logits"].numpy(),
                               np.asarray(jout["vid_logits"]), **tol)
    np.testing.assert_allclose(pout["logits_per_image"].numpy(),
                               np.asarray(jout["logits_per_image"]), **tol)


def test_whole_model_bf16_matches_jax(weights, inputs):
    """The MIXED_PRECISION policy: bf16 activations, fp32 LayerNorm,
    softmax and classifier, on both sides."""
    sd, params, arch = weights
    video, tokens = inputs
    jm = _jax(arch, fused=True, dtype=jnp.bfloat16)
    jtf = jm.apply({"params": params}, jnp.asarray(tokens, jnp.int32),
                   method=JaxCLIPDiSTModel.encode_text)
    jlog = jm.apply({"params": params}, jnp.asarray(video),
                    jtf)["logits_per_image"]
    pm = _port(sd, fused=True, dtype=torch.bfloat16)
    with torch.no_grad():
        ptf = pm.encode_text(torch.from_numpy(tokens))
        plog = pm(torch.from_numpy(video), ptf)["logits_per_image"]
    # bf16 rounds every activation to 8 mantissa bits (relative 2^-8) at
    # places the two frameworks order differently; over two layers per
    # tower and the ladder that stays within a few percent of |x| ~ 1
    np.testing.assert_allclose(ptf.float().numpy(),
                               np.asarray(jtf, np.float32), atol=5e-2)
    np.testing.assert_allclose(plog.numpy(), np.asarray(jlog), atol=5e-2)


def test_whole_model_matches_torch_golden(weights, inputs):
    sd, _, arch = weights
    video, tokens = inputs
    pm = _port(sd, fused=True)
    with torch.no_grad():
        logits = pm(torch.from_numpy(video),
                    pm.encode_text(torch.from_numpy(tokens)))
        logits = logits["logits_per_image"][:, 0, :].numpy()
        frames = torch.from_numpy(video).reshape(B * T, 32, 32, 3)
        _, _, g_taps = G.visual_tower(frames.permute(0, 3, 1, 2), sd, arch,
                                      T, DIST.alpha)
        v = G.dist_network(torch.from_numpy(video).permute(0, 4, 1, 2, 3),
                           g_taps, sd, JAX_DIST, arch.vision_width)
        tf = G.text_tower(torch.from_numpy(tokens), sd, arch)
        v = v / v.norm(dim=1, keepdim=True)
        tf = tf / tf.norm(dim=1, keepdim=True)
        want = (float(np.exp(sd["logit_scale"])) * v @ tf.T).numpy()
    np.testing.assert_allclose(logits, want, atol=1e-4, rtol=0)
