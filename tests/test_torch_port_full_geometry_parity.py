"""The port's CLIP+DiST at the production ViT-B/16 geometry (12 x 768,
224 px, 197 tokens, embed 512; the 12-step DiST ladder, integration 384 /
temporal 96, 8+16 frames) on the random fp16-quantised weights of
``tests/test_full_geometry_parity.py``: the logits and the 12 per-layer
taps against the JAX package and ``tests/torch_golden.py`` on the CPU,
the fused TemporalNet's plain version and the attention's plain version
where the card runs K1-K3. Marked ``slow`` as its JAX twin (tier-1 skips
it): ``python -m pytest -m slow tests/test_torch_port_full_geometry_parity.py``."""

import pytest

pytestmark = pytest.mark.slow  # heavy: full B/16 geometry on CPU

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax.numpy as jnp  # noqa: E402

import tests.torch_golden as G  # noqa: E402
from tests import test_full_geometry_parity as twin  # noqa: E402
from tests.synth_ckpt import add_dist_state_dict, make_clip_state_dict  # noqa: E402
from dist_tpu.models.clip.clip_video import CLIPDiSTModel as JaxModel  # noqa: E402
from dist_tpu.models.clip.convert import convert_clip_params  # noqa: E402
from dist_tpu.models.clip.model import VisionTransformer  # noqa: E402
from dist_tpu_torch.models.clip.clip_video import CLIPDiSTModel  # noqa: E402
from dist_tpu_torch.models.clip.convert import to_torch  # noqa: E402
from dist_tpu_torch.models.clip.model import sniff_architecture  # noqa: E402
from dist_tpu_torch.models.dist.dist_net import DiSTConfig  # noqa: E402


def weights(seed, arch_kw, jax_dist):
    """(the fp16-quantised reference state dict, the JAX params and arch)."""
    rng = np.random.default_rng(seed)
    state = make_clip_state_dict(rng, **arch_kw)
    add_dist_state_dict(state, rng, jax_dist, d_model=arch_kw["vision_width"])
    sd = twin._quantize_fp16(state)
    params, arch = convert_clip_params(sd, with_dist=jax_dist)
    return sd, params, arch, rng


def port(sd, jax_dist, frames):
    dist = DiSTConfig(**dataclasses.asdict(jax_dist))
    model = CLIPDiSTModel(sniff_architecture(sd), dist=dist, num_frames=frames,
                          sparse_alpha=dist.alpha, fused_temporal=True)
    model.load_state_dict(to_torch(sd))
    return model.eval()


def logits_three_ways(sd, params, arch, rng, jax_dist, frames):
    """(port, JAX, golden) logits of a (1, frames, 224, 224, 3) clip
    against 8 label texts."""
    video = (rng.standard_normal((1, frames, 224, 224, 3)) * 0.5).astype(
        np.float32)
    tokens = np.zeros((8, arch.context_length), np.int64)
    for row in range(8):
        n = int(rng.integers(5, 20))
        tokens[row, :n] = rng.integers(1, arch.vocab_size - 1, n)
        tokens[row, n - 1] = arch.vocab_size - 1    # eot = highest id
    jm = JaxModel(arch=arch, dist=jax_dist, num_frames=frames,
                  sparse_alpha=jax_dist.alpha)
    jtf = jm.apply({"params": params}, jnp.asarray(tokens.astype(np.int32)),
                   method=JaxModel.encode_text)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(video),
                               jtf)["logits_per_image"][:, 0, :])
    pm = port(sd, jax_dist, frames)
    with torch.no_grad():
        got = pm(torch.from_numpy(video), pm.encode_text(
            torch.from_numpy(tokens)))["logits_per_image"][:, 0, :].numpy()
        frames_t = torch.from_numpy(video).reshape(
            frames, 224, 224, 3).permute(0, 3, 1, 2)
        _, _, g_taps = G.visual_tower(frames_t, sd, arch, frames,
                                      jax_dist.alpha)
        v = G.dist_network(torch.from_numpy(video).permute(0, 4, 1, 2, 3),
                           g_taps, sd, jax_dist, arch.vision_width)
        tf = G.text_tower(torch.from_numpy(tokens), sd, arch)
        v = v / v.norm(dim=1, keepdim=True)
        tf = tf / tf.norm(dim=1, keepdim=True)
        golden = (float(np.exp(sd["logit_scale"])) * v @ tf.T).numpy()
    return got, want, golden


def taps_three_ways(sd, params, arch, rng, jax_dist):
    """(port, JAX, golden) (cls, logits, taps) of 4 sparse frames through
    the vision tower."""
    frames = (rng.standard_normal((1, 4, 224, 224, 3)) * 0.5).astype(
        np.float32)
    jcls, jlog, jtaps = VisionTransformer(
        arch=arch, num_frames=4, sparse_alpha=2).apply(
        {"params": params["visual"]}, jnp.asarray(frames))
    pm = port(sd, jax_dist, 4)
    with torch.no_grad():
        pcls, plog, ptaps = pm.visual(torch.from_numpy(frames))
        gcls, glog, gtaps = G.visual_tower(
            torch.from_numpy(frames).reshape(4, 224, 224, 3).permute(
                0, 3, 1, 2), sd, arch, 4, alpha=2)
    return ((pcls.numpy(), plog.numpy(), [t.numpy() for t in ptaps]),
            (np.asarray(jcls), np.asarray(jlog), [np.asarray(t) for t in jtaps]),
            (gcls.numpy(), glog.numpy(),
             [t.permute(1, 0, 2).numpy() for t in gtaps]))


def assert_logits(got, want, golden, atol):
    """The twins' bar: logit_scale (~100) times a cosine, within ``atol``
    of each reference, and the same decisions."""
    for ref in (want, golden):
        np.testing.assert_allclose(got, ref, atol=atol)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def assert_taps(three, layers, atol=1e-3):
    (pcls, plog, ptaps), *refs = three
    assert len(ptaps) == layers
    for cls, log, taps in refs:
        np.testing.assert_allclose(pcls, cls, atol=atol)
        np.testing.assert_allclose(plog, log, atol=atol)
        for i in range(layers):
            np.testing.assert_allclose(ptaps[i], taps[i], atol=atol,
                                       err_msg=f"tap {i}")


@pytest.fixture(scope="module")
def b16():
    return weights(16, twin.B16_KW, twin.B16_DIST)


def test_port_full_geometry_logits_parity(b16):
    """(1, 16, 224, 224, 3) and 8 label texts: the port's logits within
    2e-3 of the JAX package's and the golden's (its twin's bar)."""
    sd, params, arch, rng = b16
    assert arch.vision_width == 768 and arch.vision_layers == 12
    assert_logits(*logits_three_ways(sd, params, arch, rng, twin.B16_DIST,
                                     twin.B16_DIST.num_frames), atol=2e-3)


def test_port_full_geometry_taps_parity(b16):
    """The 12 taps at (8 // 2 frames, 197, 768), the cls feature and the
    projected logits within 1e-3 of both references."""
    sd, params, arch, rng = b16
    assert_taps(taps_three_ways(sd, params, arch, rng, twin.B16_DIST), 12)
