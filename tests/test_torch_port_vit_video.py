"""The port's transformer heads and VideoMAE modules against the JAX
package's on the CPU (``dist_tpu_torch/models/heads/transformer_head.py``,
``models/backbones/vit_video.py``), on seeded JAX weights brought across
by ``models/backbones/convert.py``, at the tiny geometry of
``tests/test_torch_port_video_transformer.py``:

- ``TransformerHead`` with and without ``PRE_LOGITS`` and
  ``TransformerHeadx2``, on features and on a dict, in train and eval
  mode (``TOL``; the eval scores fp32 softmax rows);
- the sin-cos table (float64, then fp32) equal to JAX's;
- ``VitVideoEncoder`` in fp32 (``TOL``) and in bf16 (``BF16_REL``);
- ``VitVideoMAEEncoder`` and ``VitVideoMAEDecoder`` with JAX's noise
  handed across: the kept tokens, ``ids_restore`` (equal) and the
  latent and the reconstruction (``TOL``), the decoder's heads
  ``DECODER_DIM // 64``; and the port's own draw from a generator."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dist_tpu.models.backbones import vit_video as jvv
from dist_tpu.models.heads import transformer_head as jth
from dist_tpu_torch.models.backbones import vit_video as vv
from dist_tpu_torch.models.heads import transformer_head as th
from tests.test_torch_port_resnet3d import cfgs, load_jax, port_module
from tests.test_torch_port_video_transformer import (
    BF16_REL,
    POOL,
    TINY,
    TOL,
    japply,
    module_variables,
    rel,
)

# vivit.yaml: the tubelet stem, TUBELET_SIZE 2
VIVIT = POOL + "vivit.yaml"


def _head_pair(kind, pre_logits):
    if kind == "x2":
        return (jth.TransformerHeadx2(num_classes=(5, 7)),
                port_module(th.TransformerHeadx2, 64, (5, 7)))
    return (jth.TransformerHead(num_classes=5, pre_logits=pre_logits),
            port_module(th.TransformerHead, 64, 5, 0.0, "softmax", pre_logits))


@pytest.mark.parametrize("as_dict", [False, True], ids=["features", "dict"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("kind,pre_logits", [("single", False),
                                             ("single", True), ("x2", False)],
                         ids=["head", "head-pre_logits", "headx2"])
def test_transformer_heads_match_jax(kind, pre_logits, train, as_dict):
    x = np.random.default_rng(30).standard_normal((3, 64)).astype(np.float32)
    jhead, head = _head_pair(kind, pre_logits)
    variables = module_variables(jhead, 31, jnp.asarray(x), train=False)
    assert ("pre_logits_fc" in variables["params"]) == pre_logits
    head = load_jax(head, variables).train(train)
    jx = {"features": jnp.asarray(x)} if as_dict else jnp.asarray(x)
    want, wfeat = jhead.apply(variables, jx, train=train)
    px = torch.from_numpy(x)
    with torch.no_grad():
        got, feat = head({"features": px} if as_dict else px)
    got = got if isinstance(got, dict) else {"scores": got}
    want = want if isinstance(want, dict) else {"scores": want}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
        if not train:
            np.testing.assert_allclose(got[k].sum(-1).numpy(), 1.0, rtol=1e-6)
    np.testing.assert_allclose(feat.numpy(), np.asarray(wfeat), **TOL)


def test_sincos_table_equals_jax():
    for n, dim in ((64, 64), (785, 384), (1568, 384)):
        got = vv.sincos_pos_embed(n, dim)
        assert got.dtype == torch.float32 and got.shape == (1, n, dim)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jvv.sincos_pos_embed(n, dim)))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_vit_video_encoder_matches_jax(repo_root, dtype):
    """Tubelet tokens (2 frames each) plus the sin-cos table, 2 joint
    layers, the plain norm, the tokens' mean: fp32 in both dtypes."""
    cfg, jcfg = cfgs(repo_root, VIVIT, TINY)
    x = np.random.default_rng(32).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    jmod = jvv.VitVideoEncoder(jcfg)
    variables = module_variables(jmod, 33, jnp.asarray(x), train=False)
    want = np.asarray(japply(jmod, variables, jnp.asarray(x, dtype)))
    mod = load_jax(port_module(vv.VitVideoEncoder, cfg), variables).eval()
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(
            torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32))
    assert got.dtype == torch.float32 and got.shape == (2, 64)
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert rel(got.numpy(), want) < BF16_REL


def test_videomae_encode_decode_with_jax_noise(repo_root):
    """``MASK_RATIO`` 0.75 over 2 x 16 tubelet tokens: JAX's encoder draws
    its noise from the ``mask`` key; the same noise handed to the port's
    encoder keeps the same 8 tokens, gives the same ``ids_restore`` and
    latent; the decoder (``DECODER_DIM`` 128: 2 heads, depth 1) puts the
    mask token at the other places and reconstructs the same 8 x 8 x 2 x 3
    pixels per token. Without the noise the port draws its own from the
    generator, the same for the same seed."""
    cfg, jcfg = cfgs(repo_root, VIVIT, TINY)
    for c in (cfg, jcfg):
        # keys no shipped config sets: the modules read them with defaults
        c.VIDEO.BACKBONE.MASK_RATIO = 0.75
        c.VIDEO.BACKBONE.DECODER_DIM = 128
        c.VIDEO.BACKBONE.DECODER_DEPTH = 1
    x = np.random.default_rng(34).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jenc, jdec = jvv.VitVideoMAEEncoder(jcfg), jvv.VitVideoMAEDecoder(jcfg)
    evars = module_variables(jenc, 35, jnp.asarray(x), train=False, rng=key)
    latent, ids = jenc.apply(evars, jnp.asarray(x), train=False, rng=key)
    dvars = module_variables(jdec, 36, latent, ids, train=False)
    pred = jdec.apply(dvars, latent, ids, train=False)
    noise = np.array(jax.random.uniform(key, (2, 32)))

    enc = load_jax(port_module(vv.VitVideoMAEEncoder, cfg), evars).eval()
    dec = load_jax(port_module(vv.VitVideoMAEDecoder, cfg), dvars).eval()
    assert dec.blocks.layer_0.attn.num_heads == 2
    with torch.no_grad():
        got_latent, got_ids = enc(torch.from_numpy(x),
                                  noise=torch.from_numpy(noise))
        got_pred = dec(got_latent, got_ids)
    assert got_latent.shape == (2, 8, 64) and got_pred.shape == (2, 32, 384)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))
    np.testing.assert_allclose(got_latent.numpy(), np.asarray(latent), **TOL)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(pred), **TOL)
    with torch.no_grad():
        draws = [enc(torch.from_numpy(x), generator=torch.Generator()
                     .manual_seed(s))[1] for s in (1, 1, 2)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])

