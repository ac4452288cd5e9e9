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
from dist_tpu_torch.tools import tnet_bwd

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


# the lengths at the edges of the kernels' routes: the whole-row instances
# pad L to 80, 208 and 272; longer rows stream
ROUTE_EDGE_LENGTHS = (1, 16, 17, 77, 80, 81, 197, 208, 209, 257, 272, 273)


def _qkv(b, l, h, hd, dt, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda").to(dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(4, 197, 12, 64), (6, 77, 8, 64),
                                   (2, 257, 16, 64), (3, 29, 4, 16),
                                   (2, 130, 2, 32), (1, 1, 1, 128),
                                   (4, 209, 4, 32)]
                         + [(4, l, 4, 64) for l in ROUTE_EDGE_LENGTHS])
def test_attention_kernel_matches_plain(shape, causal, dtype):
    b, l, h, hd = shape
    dt = getattr(torch, dtype)
    x = _qkv(b, l, h, hd, dt, seed=l * h + causal)
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


@pytest.mark.parametrize("l", [197, 77])
def test_rows_kernel_equals_k1_bit_for_bit(l):
    """K4 runs K1's device routine once per row: the same bits at every
    nb, on the whole-row route."""
    x = _qkv(8, l, 12, 64, torch.bfloat16, seed=l)
    assert att.attention_route(l, 64, torch.bfloat16) == "whole_row"
    k1 = att.fused_attention_qkv(x, 12)
    for nb in (1, 2, 4, 8):
        assert torch.equal(att.attention_qkv_rows(x, 12, nb), k1), nb


@pytest.mark.parametrize("causal", [False, True])
def test_attention_kernel_repeats_bit_for_bit(causal):
    x = _qkv(16, 197, 12, 64, torch.bfloat16, seed=3)
    assert torch.equal(att.fused_attention_qkv(x, 12, causal),
                       att.fused_attention_qkv(x, 12, causal))


@pytest.mark.parametrize("l", [1, 17])
def test_whole_row_pad_rows_are_zero_filled(l):
    """L = 1 and 17 leave 15 pad rows in the last 16-key tile. A launch
    at L = 208 on NaN inputs first leaves NaN in the SMs' shared memory;
    the short rows must still come out finite and right, which they do
    only if the pad rows of K and V are zero-filled."""
    nan = torch.full((64, 208, 3 * 4 * 64), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    att.fused_attention_qkv(nan, 4)
    x = _qkv(64, l, 4, 64, torch.bfloat16, seed=l)
    for causal in (False, True):
        got = att.fused_attention_qkv(x, 4, causal)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _within(got, att.attention_qkv_plain(x, 4, causal),
                *_bf16_attention_tolerance(x, 4 * 64))


def test_streaming_route_on_request_and_refused_routes():
    """The private ``_route="streaming"`` runs the streaming kernel where
    the rule says whole_row; the kernel refuses a route the rule does not
    name."""
    x = _qkv(4, 197, 4, 64, torch.bfloat16, seed=5)
    got = att.fused_attention_qkv(x, 4, True, _route="streaming")
    _within(got, att.attention_qkv_plain(x, 4, True),
            *_bf16_attention_tolerance(x, 4 * 64))
    with pytest.raises(RuntimeError):                  # whole_row at L 273
        att.fused_attention_qkv(_qkv(1, 273, 1, 64, torch.bfloat16, 1), 1,
                                _route="whole_row")
    with pytest.raises(RuntimeError):                  # whole_row in fp32
        att.fused_attention_qkv(_qkv(1, 77, 1, 64, torch.float32, 1), 1,
                                _route="whole_row")
    with pytest.raises(ValueError):
        att.fused_attention_qkv(x, 4, _route="fast")
    for l, hd in ((197, 64), (257, 64), (300, 64)):
        assert att.blocks_per_sm(l, hd, torch.bfloat16) >= 1


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


def _bf16_attention_tolerance(x, hd_total):
    # P and O are rounded to bf16 on both sides: one flip of P moves O by
    # <= 2^-8 max|V|, one step of O is <= 2^-7 relative
    return 2 ** -8 * float(x[..., 2 * hd_total:].float().abs().max()), 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,hd", [(197, 64), (197, 32), (77, 64), (77, 32),
                                  (273, 64), (130, 128)])
@pytest.mark.parametrize("nb", [1, 2, 4, 8])
def test_attention_rows_kernel_matches_plain(nb, l, hd, dtype):
    b, h = 8, 128 // hd
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(nb * l + hd)
    x = torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda").to(dt)
    before = att.attention_qkv_rows.launches
    got = att.attention_qkv_rows(x, h, nb)
    again = att.attention_qkv_rows(x, h, nb)
    torch.cuda.synchronize()
    assert att.attention_qkv_rows.launches == before + 2
    assert torch.equal(got, again)                     # no atomics
    want = att.attention_qkv_rows_plain(x, h, nb)
    if dt == torch.float32:
        _within(got, want, 2e-5, 1e-5)          # summation order only
    else:
        _within(got, want, *_bf16_attention_tolerance(x, h * hd))


def test_attention_rows_kernel_refuses_what_it_cannot_take():
    x = torch.zeros((6, 5, 3 * 64), device="cuda", dtype=torch.bfloat16)
    before = att.attention_qkv_rows.launches
    for nb in (4, 0, -1):                      # B % nb != 0, nb < 1
        with pytest.raises(ValueError):
            att.attention_qkv_rows(x, 1, nb)
    with pytest.raises(ValueError):            # head dim 24
        att.attention_qkv_rows(torch.zeros((2, 5, 3 * 48), device="cuda"), 2, 1)
    with pytest.raises(ValueError):            # fp16
        att.attention_qkv_rows(x.half(), 1, 2)
    assert att.attention_qkv_rows.launches == before
    # a long row at head dim 128 is not refused: it takes the streaming
    # route, K1's kernel row by row
    long = _qkv(2, 1000, 1, 128, torch.bfloat16, seed=2)
    assert att.attention_route(1000, 128, torch.bfloat16) == "streaming"
    assert torch.equal(att.attention_qkv_rows(long, 1, 1),
                       att.fused_attention_qkv(long, 1))


def test_microbatcher_round_trip_through_engine_on_card():
    """The tiny config served on the card through the MicroBatcher: every
    clip's scores equal the engine's direct predict of the same clip."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving import InferenceEngine, MicroBatcher

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        ["TRAIN.MIXED_PRECISION", "false"], make_output_dir=False)
    engine = InferenceEngine(cfg, batch_size=4)
    engine.warmup()
    assert engine.ready
    clips = np.random.default_rng(4).integers(
        0, 256, (6, 4, 64, 64, 3), dtype=np.uint8)
    batcher = MicroBatcher(engine.predict, max_batch=4, max_delay_ms=20.0)
    try:
        got = [f.result(timeout=60) for f in
               [batcher.submit(c) for c in clips]]
    finally:
        batcher.close()
    assert batcher.snapshot()["requests"] == 6
    for clip, row in zip(clips, got):
        # fp32; batches of other sizes may sum in another order
        np.testing.assert_allclose(row, engine.predict(clip[None])[0],
                                   atol=1e-6, rtol=0)


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
    params = _tn_params(8, 8, 3, 1)
    for g in (x.to(torch.bfloat16),                        # not x's dtype
              torch.zeros((1, 2, 3, 8, 3), device="cuda").transpose(3, 4),
              torch.zeros((1, 2, 3, 3, 8))):               # on the CPU
        with pytest.raises(ValueError):
            tn.fused_temporal_net_bwd(x, g, *params)


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


# K3's bf16 route (bf16 product operands, fp32 sums and elementwise steps)
# against its fp32 plain version, per output (tools/tnet_bwd.py's
# ``errors``; chip_smoke.py states the same): max |err| / max |ref| and
# ||err|| / ||ref||: 3 times the worst reading of seeds 0-2 at the train
# shape and the card tests' four shapes (python -m
# dist_tpu_torch.tools.tnet_bwd errors, H100). Why each is what it is:
#   dx        rounded to bf16 itself (2^-9 of max |dx|) on top of the
#             products' error: worst 0.0065 / 0.0033
#   dln_*     dxl (from bf16 dhb and w1) times the fp32 z, summed over N:
#             0.0065 / 0.0054 (scale), 0.0058 / 0.0055 (bias)
#   dw1, dw2  A^T B of two bf16 operands (each rounded, 2^-9) summed in
#             fp32: 0.0050 / 0.0043 and 0.0045 / 0.0038
#   db1       fp32 sums of dhb, whose dg came from bf16 dr and w2: 0.0046 /
#             0.0038
#   db2       fp32 sums of dr, whose r came from bf16 g and w2: 0.0026 /
#             0.0018
# The readings do not shrink with more positions: they are the operands'
# rounding carried through. The control (w2's (0, 0) tap zeroed in the
# plain version) reads 0.053 or more on every output, 6.9 times the
# nearest limit (db2's max_rel) or more.
BWD_BF16_LIMITS = {
    "dx": {"max_rel": 0.020, "rel_l2": 0.010},
    "dln_scale": {"max_rel": 0.020, "rel_l2": 0.017},
    "dln_bias": {"max_rel": 0.018, "rel_l2": 0.017},
    "dw1": {"max_rel": 0.015, "rel_l2": 0.013},
    "db1": {"max_rel": 0.014, "rel_l2": 0.012},
    "dw2": {"max_rel": 0.014, "rel_l2": 0.012},
    "db2": {"max_rel": 0.0077, "rel_l2": 0.0054},
}


def _bwd_tolerances(dtype, want):
    """Per-output limits of K3 against the plain version. fp32: (atol,
    rtol); both sum in fp32, in another order (the weight grads over up to
    10^5 positions in 32 chunks on the card). bf16: ``BWD_BF16_LIMITS`` on
    the readings of :func:`tnet_bwd.errors`."""
    if dtype == torch.bfloat16:
        return BWD_BF16_LIMITS
    return [(1e-5 * float(w.float().abs().max()) + 1e-6, 1e-5) for w in want]


BWD_SHAPES = [((2, 16, 14, 14, 96), 96, 3), ((2, 5, 7, 9, 16), 16, 3),
              ((1, 5, 3, 7, 40), 24, 5), ((3, 2, 14, 14, 128), 128, 1)]


def _bwd_inputs(shape, f, k, dt):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to("cuda", dt), g.to("cuda", dt), _tn_params(shape[-1], f, k,
                                                          seed=12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,f,k", BWD_SHAPES)
def test_temporal_net_bwd_kernel_matches_plain(shape, f, k, dtype):
    dt = getattr(torch, dtype)
    x, g, params = _bwd_inputs(shape, f, k, dt)
    before = tn.fused_temporal_net_bwd.launches
    got = tn.fused_temporal_net_bwd(x, g, *params)
    torch.cuda.synchronize()
    assert tn.fused_temporal_net_bwd.launches == before + 1
    want = tn.temporal_net_bwd_plain(x, g, *params)
    assert got[0].dtype == dt
    for gi, wi in zip(got, want):
        assert gi.shape == wi.shape
        assert torch.isfinite(gi.float()).all()
    if dt == torch.bfloat16:
        assert not tnet_bwd.breaches(tnet_bwd.errors(got, want),
                                     _bwd_tolerances(dt, want))
    else:
        for gi, wi, (atol, rtol) in zip(got, want, _bwd_tolerances(dt, want)):
            _within(gi, wi, atol, rtol)
    again = tn.fused_temporal_net_bwd(x, g, *params)
    for a, b in zip(got, again):                       # no atomics
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,f,k", BWD_SHAPES)
def test_temporal_net_bwd_bf16_limits_see_a_dropped_tap(shape, f, k):
    """The control: the bf16 kernel's gradients against the plain version
    with w2's (0, 0) tap zeroed break ``BWD_BF16_LIMITS``."""
    x, g, params = _bwd_inputs(shape, f, k, torch.bfloat16)
    got = tn.fused_temporal_net_bwd(x, g, *params)
    control = tn.temporal_net_bwd_plain(x, g,
                                        *tnet_bwd.control_params(params))
    assert tnet_bwd.breaches(tnet_bwd.errors(got, control), BWD_BF16_LIMITS)


def test_temporal_net_bwd_bf16_route_refuses_odd_widths():
    """The bf16 route copies rows in 16-byte pieces: C and F must be
    multiples of 8; fp32 takes any width."""
    x, g, params = _bwd_inputs((1, 2, 3, 3, 12), 12, 3, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        tn.fused_temporal_net_bwd(x, g, *params)
    got = tn.fused_temporal_net_bwd(x.float(), g.float(), *params)
    want = tn.temporal_net_bwd_plain(x.float(), g.float(), *params)
    for gi, wi, (atol, rtol) in zip(got, want, _bwd_tolerances(
            torch.float32, want)):
        _within(gi, wi, atol, rtol)


@pytest.mark.parametrize("c,f", [(96, 96), (16, 16), (40, 24), (128, 128)])
def test_temporal_net_bwd_occupancy(c, f):
    occ = tn.bwd_occupancy(c, f)
    assert list(occ) == list(tn.BWD_MMA_KERNELS)
    for v in occ.values():
        assert v["blocks_per_sm"] >= 1 and v["smem_bytes"] > 0


def _tn_module(fused, seed, c=8):
    from dist_tpu_torch.models.dist.dist_net import DiSTConfig, TemporalNet

    cfg = DiSTConfig(selected_layers=(0,), temporal_dim=c, num_frames=4)
    mod = TemporalNet(cfg, fused=fused).cuda()
    p = _tn_params(c, c, 3, seed)
    mod.load_state_dict({
        "ln.weight": p[0], "ln.bias": p[1],
        "temporal_net.c_fc1.weight": p[2].permute(4, 3, 0, 1, 2),
        "temporal_net.c_fc1.bias": p[3],
        "temporal_net.c_fc2.weight": p[4].permute(4, 3, 0, 1, 2),
        "temporal_net.c_fc2.bias": p[5]})
    return mod


def test_function_grads_match_unfused_module():
    """Autograd through K2/K3 gives the unfused module's (cuDNN convs)
    gradients for x and every parameter, fp32."""
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.standard_normal((2, 4, 5, 6, 8)).astype(
        np.float32)).cuda()
    g = torch.from_numpy(rng.standard_normal((2, 4, 5, 6, 8)).astype(
        np.float32)).cuda()
    grads = []
    for fused in (True, False):
        mod = _tn_module(fused, seed=3)
        x = x0.clone().requires_grad_()
        before = tn.fused_temporal_net_bwd.launches
        mod(x).backward(g)
        assert tn.fused_temporal_net_bwd.launches == before + int(fused)
        grads.append([x.grad] + [p.grad for _, p in sorted(
            mod.named_parameters())])
    for a, b in zip(*grads):
        _within(a, b, 1e-5 * float(b.abs().max()) + 1e-6, 1e-5)


def test_fused_forward_after_adamw_step_uses_new_weights():
    """The no-grad forward's cached pack is not reused after a training
    step changes the parameters in place (AdamW, the default foreach
    implementation on the card)."""
    mod = _tn_module(True, seed=4)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 4, 5, 6, 8)).astype(np.float32)).cuda()
    opt = torch.optim.AdamW(mod.parameters(), lr=1e-2, weight_decay=1e-4)
    with torch.no_grad():
        before = mod(x)
    mod(x).square().mean().backward()
    opt.step()
    with torch.no_grad():
        after = mod(x)
        want = tn.temporal_net_plain(x, *mod._raw_params())
    assert not torch.equal(after, before)
    _within(after, want, 1e-4, 1e-5)


def test_tiny_train_step_runs_through_all_kernels():
    """One train step of the tiny config on the card: 2 K1 (frozen vision
    tower), 2 K2 and 2 K3 launches; frozen parameters unchanged bit for
    bit, every dist_net parameter with a gradient moved, a finite loss."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        compute_text_features,
        create_train_state,
        make_train_step,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        ["TPU.FUSED_TEMPORAL_NET", "true"], make_output_dir=False)
    model = build_model(cfg)
    tokens = np.random.default_rng(1).integers(1, 100, (12, 77))
    text = compute_text_features(model, tokens)
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    state = create_train_state(model, optimizer)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    before = {k: v.clone() for k, v in model.module.state_dict().items()}
    rng = np.random.default_rng(2)
    batch = {"video": torch.from_numpy(rng.integers(
                 0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)).cuda(),
             "labels": torch.tensor([3, 7]).cuda(), "text_features": text}
    att.fused_attention_qkv.launches = 0
    tn.fused_temporal_net.launches = 0
    tn.fused_temporal_net_bwd.launches = 0
    metrics = step(state, batch, torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    assert (att.fused_attention_qkv.launches, tn.fused_temporal_net.launches,
            tn.fused_temporal_net_bwd.launches) == (2, 2, 2)
    assert bool(torch.isfinite(metrics["loss"]))
    for k, p in model.module.named_parameters():
        if not k.startswith("dist_net."):
            assert p.grad is None and torch.equal(p, before[k]), k
        elif bool(p.grad.abs().max() > 0):
            assert not torch.equal(p, before[k]), k
