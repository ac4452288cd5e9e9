"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips
without a GPU. This file imports neither JAX nor the JAX package, so it
runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from dist_tpu_torch.ops import attention as att
from dist_tpu_torch.ops import temporal_net as tn

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _within(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    bad = err > atol + rtol * want.float().abs()
    assert not bad.any(), f"max abs err {float(err.max())}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 197, 12, 64), (6, 77, 8, 64),
                                   (2, 257, 16, 64), (3, 29, 4, 16),
                                   (2, 130, 2, 32), (1, 1, 1, 128)])
def test_attention_kernel_matches_plain(shape, causal, dtype):
    b, l, h, hd = shape
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(l * h + causal)
    x = torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda").to(dt)
    before = att.fused_attention_qkv.launches
    got = att.fused_attention_qkv(x, h, causal)
    torch.cuda.synchronize()
    assert att.fused_attention_qkv.launches == before + 1
    want = att.attention_qkv_plain(x, h, causal)
    if dt == torch.float32:
        _within(got, want, 2e-5, 1e-5)          # summation order only
    else:
        # P and O are rounded to bf16 on both sides: one flip of P moves O
        # by <= 2^-8 max|V|, one step of O is <= 2^-7 relative
        vmax = float(x[..., 2 * h * hd:].float().abs().max())
        _within(got, want, 2 ** -8 * vmax, 2 ** -7)


def test_attention_kernel_refuses_what_it_cannot_take():
    x = torch.zeros((2, 5, 3 * 2 * 24), device="cuda")
    with pytest.raises(ValueError):
        att.fused_attention_qkv(x, 2)                   # head dim 24
    with pytest.raises(ValueError):
        att.fused_attention_qkv(x.half(), 3)            # fp16
    with pytest.raises(ValueError):
        att.fused_attention_qkv(x.transpose(0, 1), 3)   # not contiguous
    flat = torch.zeros(1 + 2 * 5 * 3 * 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # not 16-byte aligned
        att.fused_attention_qkv(flat[1:].view(2, 5, 3 * 64), 1)


def _tn_params(c, f, k, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s, sc: torch.from_numpy(
        (rng.standard_normal(s) * sc).astype(np.float32)).cuda()
    return (1.0 + r(c, sc=0.1), r(c, sc=0.1), r(k, 1, 1, c, f, sc=(k * c) ** -0.5),
            r(f, sc=0.1), r(1, 3, 3, f, c, sc=(9 * f) ** -0.5), r(c, sc=0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,f,k", [((2, 16, 14, 14, 96), 96, 3),
                                       ((2, 4, 5, 6, 8), 8, 3),
                                       ((1, 5, 3, 7, 40), 24, 5),
                                       ((3, 2, 14, 14, 128), 128, 1)])
def test_temporal_net_kernel_matches_plain(shape, f, k, dtype):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    x = x.to("cuda", dt)
    params = _tn_params(shape[-1], f, k, seed=8)
    before = tn.fused_temporal_net.launches
    got = tn.fused_temporal_net(x, *params)
    torch.cuda.synchronize()
    assert tn.fused_temporal_net.launches == before + 1
    want = tn.temporal_net_plain(x, *params)
    if dt == torch.float32:
        _within(got, want, 1e-4, 1e-5)          # summation order only
    else:
        _within(got, want, 1e-4, 2 ** -7)       # one bf16 step of the output


def test_temporal_net_kernel_refuses_what_it_cannot_take():
    x = torch.zeros((1, 2, 3, 3, 160), device="cuda")
    with pytest.raises(ValueError):                        # C > 128
        tn.fused_temporal_net(x, *_tn_params(160, 160, 3, seed=1))
    x = torch.zeros((1, 2, 3, 3, 8), device="cuda")
    with pytest.raises(ValueError):                        # params on the CPU
        tn.fused_temporal_net(x, *(p.cpu() for p in _tn_params(8, 8, 3, 1)))


def test_fused_module_repacks_after_new_weights():
    """The fused TemporalNet keeps its packed weights between calls and
    packs again after ``load_state_dict`` brings new ones."""
    from dist_tpu_torch.models.dist.dist_net import DiSTConfig, TemporalNet

    cfg = DiSTConfig(selected_layers=(0,), temporal_dim=8, num_frames=4)
    mod = TemporalNet(cfg, fused=True).cuda()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 5, 6, 8)).astype(np.float32)).cuda()
    for seed in (1, 2):
        p = _tn_params(8, 8, 3, seed)
        mod.load_state_dict({
            "ln.weight": p[0], "ln.bias": p[1],
            "temporal_net.c_fc1.weight": p[2].permute(4, 3, 0, 1, 2),
            "temporal_net.c_fc1.bias": p[3],
            "temporal_net.c_fc2.weight": p[4].permute(4, 3, 0, 1, 2),
            "temporal_net.c_fc2.bias": p[5]})
        with torch.no_grad():
            got = mod(x)
            packed = mod._packed
            again = mod(x)
        assert mod._packed is packed
        torch.testing.assert_close(again, got, rtol=0, atol=0)
        _within(got, tn.temporal_net_plain(x, *p), 1e-4, 1e-5)


def test_served_tiny_model_runs_through_both_kernels():
    """The tiny config served on the card: every request batch launches
    the attention kernel once per vision layer and the TemporalNet kernel
    once per ladder step; scores match the CPU plain path."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.tasks.state import _prep_video

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        ["TPU.FUSED_TEMPORAL_NET", "true", "TRAIN.MIXED_PRECISION", "false"],
        make_output_dir=False)
    att.fused_attention_qkv.launches = 0
    tn.fused_temporal_net.launches = 0
    engine = InferenceEngine(cfg, batch_size=4)
    clips = np.random.default_rng(0).integers(
        0, 256, (3, 4, 64, 64, 3), dtype=np.uint8)
    got = engine.predict(clips)
    assert att.fused_attention_qkv.launches == 2 + 2     # text + vision
    assert tn.fused_temporal_net.launches == 2
    cpu = build_model(cfg, device="cpu")
    with torch.no_grad():
        want, _ = cpu.apply({
            "video": _prep_video(cfg, torch.from_numpy(clips)),
            "text_features": engine.text_features.cpu()})
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5, rtol=0)
