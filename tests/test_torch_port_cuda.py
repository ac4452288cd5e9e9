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
from dist_tpu_torch.tools import tnet_bwd, tnet_fwd

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# The tiny run list (tiny_synth.yaml: test, then the 3-view test) in bf16,
# the TemporalNet fused, against the same weights in fp32 on the CPU: the
# largest difference of a video's ensembled score divided by its views.
# 3 times the worst reading of weight seeds 0-2 (python -m
# dist_tpu_torch.tools.run_list_errors): bf16 on the CPU 0.0079, 0.0084,
# 0.0090; on an H100 0.0070, 0.0087, 0.0105; the scores of 12 classes sum
# to 1 a view. tests/test_torch_port_test_task.py holds the CPU's bf16
# run list to the JAX package's fp32 one with it, and the card test below
# the card's to the CPU's fp32 one.
RUN_LIST_BF16_LIMIT = 0.032
# The tiny run list with training (two fold-epochs of two steps, mixup
# off) in bf16 with the TemporalNet fused, against its fp32 run list: the
# relative difference of a step's loss. 3 times the worst reading on the
# CPU (1.4e-4 to 1.01e-3 over the 4 steps, tests/test_torch_port_train_run.py);
# the card test below holds the card's bf16 list to the CPU's fp32 one
# with it.
TRAIN_RUN_BF16_LOSS_RTOL = 3.0e-3


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


FWD_SHAPES = [((2, 16, 14, 14, 96), 96, 3), ((2, 4, 5, 6, 8), 8, 3),
              ((1, 5, 3, 7, 40), 24, 5), ((3, 2, 14, 14, 128), 128, 1)]


def _fwd_inputs(shape, f, k, dt):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to("cuda", dt), _tn_params(shape[-1], f, k, seed=8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,f,k", FWD_SHAPES)
def test_temporal_net_kernel_matches_plain(shape, f, k, dtype):
    dt = getattr(torch, dtype)
    x, params = _fwd_inputs(shape, f, k, dt)
    before = tn.fused_temporal_net.launches
    got = tn.fused_temporal_net(x, *params)
    torch.cuda.synchronize()
    assert tn.fused_temporal_net.launches == before + 1
    want = tn.temporal_net_plain(x, *params)
    assert got.dtype == dt and got.shape == want.shape
    if dt == torch.float32:
        _within(got, want, 1e-4, 1e-5)          # summation order only
    else:
        # bf16 product operands (xl, g, w1, w2), fp32 sums, the output
        # rounded once: tnet_fwd.FWD_BF16_LIMITS, each with its reason
        assert torch.isfinite(got.float()).all()
        assert not tnet_bwd.breaches(tnet_fwd.errors(got, want),
                                     tnet_fwd.FWD_BF16_LIMITS)


@pytest.mark.parametrize("shape,f,k", FWD_SHAPES)
def test_temporal_net_bf16_limits_see_a_dropped_tap(shape, f, k):
    """The control: the bf16 kernel's output against the plain version
    with w2's (0, 0) tap zeroed breaks ``FWD_BF16_LIMITS``."""
    x, params = _fwd_inputs(shape, f, k, torch.bfloat16)
    got = tn.fused_temporal_net(x, *params)
    control = tn.temporal_net_plain(x, *tnet_bwd.control_params(params))
    assert tnet_bwd.breaches(tnet_fwd.errors(got, control),
                             tnet_fwd.FWD_BF16_LIMITS)


@pytest.mark.parametrize("shape,f,k", FWD_SHAPES)
def test_temporal_net_bf16_repeats_bit_for_bit(shape, f, k):
    """No atomics and fixed-order sums: two launches, the same bits."""
    x, params = _fwd_inputs(shape, f, k, torch.bfloat16)
    assert tn.temporal_net_fwd_route(x.dtype) == "bf16_mma"
    assert torch.equal(tn.fused_temporal_net(x, *params),
                       tn.fused_temporal_net(x, *params))


def test_temporal_net_bf16_route_refuses_odd_widths():
    """The bf16 route copies rows in 16-byte pieces: C and F must be
    multiples of 8, and a bf16 tensor of another width raises rather than
    taking the fp32 kernels; fp32 takes any width."""
    x, params = _fwd_inputs((1, 2, 3, 3, 12), 12, 3, torch.bfloat16)
    before = tn.fused_temporal_net.launches
    with pytest.raises(ValueError, match="multiples of 8"):
        tn.fused_temporal_net(x, *params)
    x8, params8 = _fwd_inputs((1, 2, 3, 3, 8), 12, 3, torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):   # F = 12
        tn.fused_temporal_net(x8, *params8)
    assert tn.fused_temporal_net.launches == before
    _within(tn.fused_temporal_net(x.float(), *params),
            tn.temporal_net_plain(x.float(), *params), 1e-4, 1e-5)


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


def test_exported_tiny_model_on_the_card(tmp_path):
    """The tiny config exported on the card (``serving/export.py``),
    saved, loaded on the card: the engine's scores, and each call of the
    program launches K1 once per vision layer (never the text tower's
    causal K1: its features are baked in) and K2 once per ladder step."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.serving.export import (
        export_predictor,
        load_predictor,
        save_exported,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        ["TPU.FUSED_TEMPORAL_NET", "true", "TRAIN.MIXED_PRECISION", "false"],
        make_output_dir=False)
    path = str(tmp_path / "tiny.pt2")
    save_exported(path, *export_predictor(cfg, batch_size=4))
    predict, meta = load_predictor(path)
    assert meta["exported_on"] == "cuda"
    engine = InferenceEngine(cfg, batch_size=4)
    clips = np.random.default_rng(0).integers(
        0, 256, (3, 4, 64, 64, 3), dtype=np.uint8)
    causal = []
    real_launch = att._launch

    def launch(fn, qkv, route, heads, is_causal, *args):
        causal.append(is_causal)
        return real_launch(fn, qkv, route, heads, is_causal, *args)

    att._launch = launch
    try:
        for _ in range(2):
            att.fused_attention_qkv.launches = 0
            tn.fused_temporal_net.launches = 0
            got = predict(clips)
            torch.cuda.synchronize()
            assert att.fused_attention_qkv.launches == 2
            assert tn.fused_temporal_net.launches == 2
    finally:
        att._launch = real_launch
    assert causal == [0] * 4
    np.testing.assert_allclose(got, engine.predict(clips), atol=1e-5, rtol=0)


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


@pytest.mark.parametrize("c,f", [(96, 96), (8, 8), (40, 24), (128, 128)])
def test_temporal_net_fwd_occupancy(c, f):
    """K2's bf16 stages fit as K3's do: the same shared memory a block."""
    occ = tn.fwd_occupancy(c, f)
    assert list(occ) == list(tn.FWD_MMA_KERNELS)
    bwd = tn.bwd_occupancy(c, f)
    for v in occ.values():
        assert v["blocks_per_sm"] >= 1
        assert v["smem_bytes"] == bwd["stage_B"]["smem_bytes"]


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
    metrics = step(state, batch)
    torch.cuda.synchronize()
    assert (att.fused_attention_qkv.launches, tn.fused_temporal_net.launches,
            tn.fused_temporal_net_bwd.launches) == (2, 2, 2)
    assert bool(torch.isfinite(metrics["loss"]))
    for k, p in model.module.named_parameters():
        if not k.startswith("dist_net."):
            assert p.grad is None and torch.equal(p, before[k]), k
        elif bool(p.grad.abs().max() > 0):
            assert not torch.equal(p, before[k]), k


def test_tiny_run_list_on_the_card(tmp_path):
    """The tiny run list (test, then the 3-view test) on the card in bf16
    with the fused TemporalNet, against the CPU's fp32 run list on the
    same .pyth: per-video scores within ``RUN_LIST_BF16_LIMIT`` per view,
    every view counted once, and per run K1 launched once per vision
    layer per batch plus once per text layer at set-up, K2 once per
    ladder step per batch."""
    import os

    from dist_tpu_torch import run
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml")
    ckpt = str(tmp_path / "weights.pyth")
    opts = ["TRAIN.ENABLE", "false", "TPU.FUSED_TEMPORAL_NET", "true",
            "OUTPUT_DIR", str(tmp_path), "TEST.CHECKPOINT_FILE_PATH", ckpt]
    cfg = load_config(path, opts, make_output_dir=False)
    torch.save(build_model(cfg, device="cpu", seed=0).module.state_dict(),
               ckpt)
    layers, steps = 2, len(cfg.VIDEO.BACKBONE.DIST.SELECTED_LAYERS)
    card = []
    for run_cfg, func in run._prepare_data(cfg):
        att.fused_attention_qkv.launches = 0
        tn.fused_temporal_net.launches = 0
        meter = func(run_cfg)
        batches = meter.timing["batches"]
        assert att.fused_attention_qkv.launches == layers * batches + layers
        assert tn.fused_temporal_net.launches == steps * batches
        card.append(meter)
    cpu = run.main(["--cfg", path, "--device", "cpu", *opts,
                    "TRAIN.MIXED_PRECISION", "false"])
    assert [m.num_clips for m in card] == [1, 3]
    for got, want in zip(card, cpu):
        np.testing.assert_array_equal(got.clip_count, got.num_clips)
        np.testing.assert_array_equal(got.video_labels, want.video_labels)
        err = np.abs(got.video_preds - want.video_preds).max() / got.num_clips
        assert err <= RUN_LIST_BF16_LIMIT, err


def test_tiny_run_list_with_training_on_the_card(tmp_path):
    """The tiny run list with training first (train -> test -> 3-view
    test; 4 steps, mixup off, EMA on) on the card in bf16 with the fused
    TemporalNet, against the CPU's fp32 list from the same .pyth: each
    step's loss within ``TRAIN_RUN_BF16_LOSS_RTOL`` and its LR equal, the
    same checkpoints, the test entries' per-video scores within
    ``RUN_LIST_BF16_LIMIT`` per view, and K3 launched once per ladder step
    per train step."""
    import os

    from dist_tpu_torch import run
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks import train as train_task

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml")
    ckpt = str(tmp_path / "weights.pyth")
    opts = ["AUGMENTATION.MIXUP.ENABLE", "false", "AUGMENTATION.CUTMIX.ENABLE",
            "false", "MODEL.EMA.ENABLE", "true", "MODEL.EMA.DECAY", "0.9",
            "OPTIMIZER.MAX_EPOCH", "2", "TRAIN.BATCH_SIZE", "8",
            "TEST.BATCH_SIZE", "8", "TRAIN.CHECKPOINT_FILE_PATH", ckpt,
            "VIDEO.BACKBONE.LOCAL_PRETRAIN_WEIGHT_PATH", ckpt,
            "TPU.FUSED_TEMPORAL_NET", "true"]
    cfg = load_config(path, opts + ["OUTPUT_DIR", str(tmp_path / "card")])
    torch.save(build_model(cfg, device="cpu", seed=0).module.state_dict(),
               ckpt)
    losses = {"card": [], "cpu": []}
    plain = train_task.TrainMeter

    def recording(key):
        class Recorded(plain):
            def update_stats(self, top1, top5, loss, lr, mb):
                losses[key].append((loss, lr))
                super().update_stats(top1, top5, loss, lr, mb)
        return Recorded

    try:
        train_task.TrainMeter = recording("card")
        card = []
        for run_cfg, func in run._prepare_data(cfg):
            tn.fused_temporal_net_bwd.launches = 0
            card.append(func(run_cfg))
            if func is train_task.train:
                assert tn.fused_temporal_net_bwd.launches == 2 * 4
        train_task.TrainMeter = recording("cpu")
        cpu = run.main(["--cfg", path, "--device", "cpu", *opts,
                        "TRAIN.MIXED_PRECISION", "false",
                        "OUTPUT_DIR", str(tmp_path / "cpu")])
    finally:
        train_task.TrainMeter = plain
    assert card[0].step == cpu[0].step == 4 and len(losses["card"]) == 4
    for (gl, glr), (wl, wlr) in zip(losses["card"], losses["cpu"]):
        assert abs(gl - wl) <= TRAIN_RUN_BF16_LOSS_RTOL * abs(wl), (gl, wl)
        assert glr == wlr
    names = [sorted(os.listdir(tmp_path / d / "checkpoints"))
             for d in ("card", "cpu")]
    assert names[0] == names[1]
    for got, want in zip(card[1:], cpu[1:]):
        np.testing.assert_array_equal(got.clip_count, got.num_clips)
        err = np.abs(got.video_preds - want.video_preds).max() / got.num_clips
        assert err <= RUN_LIST_BF16_LIMIT, err


def _l14_tiny(cfg, remat):
    """An L/14-shaped tiny model on the card: patch 14 at 56 px (a 4 x 4
    grid), 3 heads of 64, 2 layers, every layer selected, 8 dense and 4
    sparse frames, ``S_PATCH_SIZE`` 14, the TemporalNet fused, bf16;
    weights from seed 0."""
    from dist_tpu_torch.models.base.blocks import init_weights
    from dist_tpu_torch.models.base.models import VideoModel, build_head
    from dist_tpu_torch.models.clip.clip_video import CLIPDiSTModel
    from dist_tpu_torch.models.clip.model import CLIPArchitecture
    from dist_tpu_torch.models.dist.dist_net import DiSTConfig

    arch = CLIPArchitecture(32, 56, 2, 192, 14, 77, 49408, 64, 1, 1)
    dist = DiSTConfig(selected_layers=(0, 1), temporal_dim=16,
                      integration_dim=64, s_patch_size=14, t_patch_size=5,
                      num_frames=8, alpha=2)
    with torch.device("meta"):
        module = CLIPDiSTModel(arch, dist, num_frames=8, sparse_alpha=2,
                               dtype=torch.bfloat16, fused_temporal=True,
                               remat=remat)
    module = module.to_empty(device="cpu")
    init_weights(module, torch.Generator().manual_seed(0))
    return VideoModel(module=module.cuda().eval(), head=build_head(cfg),
                      cfg=cfg)


def test_l14_tiny_train_step_with_remat_equals_without():
    """One train step of an L/14-shaped tiny model (``TPU.REMAT true``,
    tiny_synth's optimizer, label smoothing and mixup/cutmix) on the card:
    per step K1 2 (the frozen tower's layers), K2 4 (the 2 ladder steps'
    forward and remat's recompute) and K3 2; the loss and every gradient
    equal to the same step without remat, bit for bit (the same launches
    on the same values)."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        ["TPU.FUSED_TEMPORAL_NET", "true", "TPU.REMAT", "true",
         "DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "56"],
        make_output_dir=False)
    rng = np.random.default_rng(3)
    batch = {"video": torch.from_numpy(rng.integers(
                 0, 256, (2, 8, 56, 56, 3), dtype=np.uint8)).cuda(),
             "labels": torch.tensor([3, 7]).cuda(),
             "text_features": torch.from_numpy(rng.standard_normal(
                 (12, 32)).astype(np.float32)).cuda()}
    out = {}
    for remat in (True, False):
        model = _l14_tiny(cfg, remat)
        optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
        step = make_train_step(model, cfg, optimizer, lr_fn)
        att.fused_attention_qkv.launches = 0
        tn.fused_temporal_net.launches = 0
        tn.fused_temporal_net_bwd.launches = 0
        loss = step(create_train_state(model, optimizer), batch)["loss"]
        torch.cuda.synchronize()
        assert (att.fused_attention_qkv.launches,
                tn.fused_temporal_net.launches,
                tn.fused_temporal_net_bwd.launches) == (2, 4 if remat else 2,
                                                        2)
        assert bool(torch.isfinite(loss))
        out[remat] = (loss, {k: p.grad for k, p in
                             model.module.named_parameters()
                             if p.requires_grad})
    assert torch.equal(out[True][0], out[False][0])
    assert sorted(out[True][1]) == sorted(out[False][1])
    for k, g in out[False][1].items():
        assert torch.equal(out[True][1][k], g), k


def test_tiny_ddp_step_at_nccl_world_1_equals_plain_step(tmp_path):
    """Two train steps of the tiny config, the TemporalNet fused, through
    ``DistributedDataParallel`` in an NCCL group of one rank
    (``parallel/mesh.py::wrap_ddp``, a ``file://`` store) against the same
    steps without it, from the same weights: the losses and every
    trainable gradient equal bit for bit (one rank's all-reduce divides by
    one), and 2 launches of each of K1, K2 and K3 per step on both."""
    import os

    import torch.distributed as dist

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel.mesh import init_distributed, wrap_ddp
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(
        os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        ["TPU.FUSED_TEMPORAL_NET", "true"], make_output_dir=False)
    rng = np.random.default_rng(4)
    batches = [{"video": torch.from_numpy(rng.integers(
                    0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)).cuda(),
                "labels": torch.tensor([3, 7]).cuda(),
                "text_features": torch.from_numpy(rng.standard_normal(
                    (12, 32)).astype(np.float32)).cuda()} for _ in range(2)]
    init_distributed(cfg, "cuda:0", 0, 1, "file://" + str(tmp_path / "store"))
    try:
        assert dist.get_backend() == "nccl"
        out = {}
        for ddp in (False, True):
            model = build_model(cfg)
            optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
            state = create_train_state(model, optimizer)
            if ddp:
                wrap_ddp(model)
            step = make_train_step(model, cfg, optimizer, lr_fn)
            out[ddp] = []
            for batch in batches:
                att.fused_attention_qkv.launches = 0
                tn.fused_temporal_net.launches = 0
                tn.fused_temporal_net_bwd.launches = 0
                loss = step(state, batch)["loss"]
                torch.cuda.synchronize()
                assert (att.fused_attention_qkv.launches,
                        tn.fused_temporal_net.launches,
                        tn.fused_temporal_net_bwd.launches) == (2, 2, 2)
                out[ddp].append((loss, {
                    k: p.grad.clone() for k, p in
                    model.module.named_parameters() if p.requires_grad}))
    finally:
        dist.destroy_process_group()
    for (loss, grads), (want_loss, want) in zip(out[True], out[False]):
        assert torch.equal(loss, want_loss)
        assert sorted(grads) == sorted(want)
        for k, g in want.items():
            assert torch.equal(grads[k], g), k


# the tiny geometry of tests/test_model_zoo_harness.py::TINY_OPTS (this
# file imports no other test module: it runs where the repository's other
# tests cannot)
ZOO_TINY_OPTS = [
    "VIDEO.BACKBONE.META_ARCH_NAME", "ViT-Test",
    "VIDEO.BACKBONE.PRETRAIN_WEIGHT_PATH", "",
    "VIDEO.BACKBONE.LOCAL_PRETRAIN_WEIGHT_PATH", "",
    "VIDEO.BACKBONE.DIST.SELECTED_LAYERS", "[0,1]",
    "VIDEO.BACKBONE.DIST.INTEGRATION_DIM", "64",
    "VIDEO.BACKBONE.DIST.TEMPORAL_DIM", "32",
    "VIDEO.HEAD.NUM_CLASSES", "12",
    "DATA.NUM_INPUT_FRAMES", "4",
    "DATA.TRAIN_CROP_SIZE", "64", "DATA.TEST_SCALE", "64",
    "DATA.TEST_CROP_SIZE", "64",
]


def test_zoo_dry_run_on_the_card(tmp_path):
    """The Model-Zoo harness's dry run of all eight rows at the tiny
    geometry of tests/test_model_zoo_harness.py on the card, bf16 with the
    TemporalNet fused: exit 0, each row 2 x 1 views, and per row (2
    videos of 2 views at batch 1: 4 batches) K1 launched once per vision
    layer per batch and once per text layer at set-up, K2 once per ladder
    step per batch."""
    import contextlib
    import io
    import json

    from dist_tpu_torch.tools import reproduce_model_zoo as zoo

    att.fused_attention_qkv.launches = 0
    tn.fused_temporal_net.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = zoo.main(["--dry-run", "--dry-run-samples", "2",
                         "--output-dir", str(tmp_path), "--opts",
                         "TPU.FUSED_TEMPORAL_NET", "true", *ZOO_TINY_OPTS])
    assert code == 0
    rows = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith('{"config"')]
    assert len(rows) == 8
    assert all(r["dry_run"] and r["views"] == "2x1" for r in rows)
    layers, steps, batches = 2, 2, 4
    assert att.fused_attention_qkv.launches == 8 * (layers * batches + layers)
    assert tn.fused_temporal_net.launches == 8 * steps * batches


TADA_TINY_OPTS = ["VIDEO.BACKBONE.DEPTH", "18",
                  "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
                  "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "32",
                  "DATA.TEST_CROP_SIZE", "32", "VIDEO.HEAD.NUM_CLASSES", "7",
                  "VIDEO.HEAD.DROPOUT_RATE", "0.0"]


def test_tiny_tada2d_on_the_card_matches_the_cpu():
    """A tiny TAda2D (the zero inits drawn: alpha away from 1, the
    avg-pool branch on), fp32 with TF32 off: its eval scores on the card
    within 1e-5 of the CPU's; one train step's loss within 1e-5
    (relative) and its running stats within 1e-5 (relative L2); K1-K4
    launch no time."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        _prep_video,
        create_train_state,
        make_train_step,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs/projects/tada/k400/"
                                   "tada2d_8x8.yaml"), TADA_TINY_OPTS,
                      make_output_dir=False)
    gen = torch.Generator().manual_seed(0)
    clips = torch.randint(0, 256, (2, 4, 32, 32, 3), generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    labels = torch.tensor([1, 5])
    cpu = build_model(cfg, device="cpu")
    with torch.no_grad():
        for name, p in cpu.module.named_parameters():
            if name.endswith("b_rf.b.weight") or "b_avgpool_bn" in name:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen) + 0.5)
    weights = {k: v.clone() for k, v in cpu.module.state_dict().items()}
    card = build_model(cfg, device="cuda")
    card.module.load_state_dict(weights)
    counts = (att.fused_attention_qkv, att.attention_qkv_rows,
              tn.fused_temporal_net, tn.fused_temporal_net_bwd)
    for fn in counts:
        fn.launches = 0
    with torch.no_grad():
        want, _ = cpu.apply({"video": _prep_video(cfg, clips)})
        got, _ = card.apply({"video": _prep_video(cfg, clips.cuda())})
    _within(got.cpu(), want, 1e-5, 0)
    out = []
    for model in (cpu, card):
        opt, lr_fn = construct_optimizer(cfg, model.module, 4)
        metrics = make_train_step(model, cfg, opt, lr_fn)(
            create_train_state(model, opt),
            {"video": clips.to(model.device), "labels": labels.to(model.device)})
        stats = torch.cat([v.flatten().cpu() for k, v in
                           model.module.state_dict().items()
                           if k.endswith("running_var")
                           or k.endswith("running_mean")]
                          + [torch.zeros(0, dtype=torch.float64)])
        out.append((float(metrics["loss"]), stats))
    (lc, sc), (lg, sg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert float((sg - sc).norm() / sc.norm()) <= 1e-5
    assert all(fn.launches == 0 for fn in counts)


# The conv family beyond TAda2D, tiny, card against CPU (cuDNN's
# convolutions against oneDNN's): eval scores in fp32 with TF32 off within
# CONV_SCORE_ATOL (the tiny models' CPU parity tolerance); one train step
# in float64 on both sides (in fp32 these random deep nets' gradients
# carry the convolutions' rounding grown with depth, 9.3 % all together
# on the H100): its loss within CONV_LOSS_RTOL (relative), its running
# stats within CONV_STATS_REL (relative L2, all together) and every
# gradient leaf within CONV_GRAD_REL of its own norm (or of GRAD_FLOOR
# times the largest leaf's, for a gradient that is 0 in exact
# arithmetic): chip_smoke.py's FP64_STEP_LIMITS, set before the card's
# first reading.
CONV_SCORE_ATOL = 2e-4
CONV_LOSS_RTOL = 1e-10
CONV_STATS_REL = 1e-10
CONV_GRAD_REL = 1e-7
GRAD_FLOOR = 1e-6
CONV_TINY = {
    "slowfast": ("configs/projects/tada/slowfast_ek100.yaml",
                 ["VIDEO.BACKBONE.NUM_FILTERS", "[32, 32, 64, 128, 256]",
                  "DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "64",
                  "DATA.TEST_CROP_SIZE", "64", "VIDEO.HEAD.NUM_CLASSES",
                  "[5, 7]", "VIDEO.HEAD.DROPOUT_RATE", "0.0"], 2),
    "csn": ("configs/projects/tada/csn_ek100.yaml",
            ["VIDEO.BACKBONE.DEPTH", "10",
             "VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64, 128]",
             "DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "64",
             "DATA.TEST_CROP_SIZE", "64", "VIDEO.HEAD.NUM_CLASSES", "[5, 7]",
             "VIDEO.HEAD.DROPOUT_RATE", "0.0"], 2),
    "s3dg": ("configs/projects/hico/ft_s3dg_hmdb.yaml",
             ["DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32",
              "DATA.TEST_CROP_SIZE", "32", "VIDEO.HEAD.NUM_CLASSES", "7",
              "VIDEO.HEAD.DROPOUT_RATE", "0.0",
              "TRAIN.CHECKPOINT_FILE_PATH", ""], 8),
}


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


def _worst_leaf(got, want):
    """(relative L2, name) of the gradient leaf of ``got`` farthest from
    ``want``'s, each relative to its norm in ``want`` or to GRAD_FLOOR
    times the largest such norm where that is larger."""
    least = GRAD_FLOOR * max(float(w.norm()) for w in want.values())
    return max((float((got[k] - w).norm()) / max(float(w.norm()), least,
                                                  1e-300), k)
               for k, w in want.items())


def tiny_conv_readings(name, table=CONV_TINY):
    """The card-against-CPU readings of the test below for one of
    ``table`` (CONV_TINY or TRANSFORMER_TINY): ({"scores": the largest
    score difference over the heads (fp32), "loss", "stats", "grads",
    "worst": the float64 step's}, the CPU step's metric names, the card
    step's)."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        _prep_video,
        create_train_state,
        make_train_step,
    )

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path, opts, n = table[name]
    cfg = load_config(os.path.join(repo, path), opts, make_output_dir=False)
    dual = isinstance(cfg.VIDEO.HEAD.NUM_CLASSES, (list, tuple))
    t, s = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    gen = torch.Generator().manual_seed(1)
    clips = torch.randint(0, 256, (n, t, s, s, 3), generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    batch = {"video": _prep_video(cfg, clips).double(),
             "labels": torch.arange(n) % 5}
    if dual:
        batch.update(label_verb=torch.arange(n) % 5,
                     label_noun=(torch.arange(n) + 3) % 7)
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    card.module.load_state_dict(cpu.module.state_dict())
    with torch.no_grad():
        want, _ = cpu.apply({"video": _prep_video(cfg, clips)})
        got, _ = card.apply({"video": _prep_video(cfg, clips.cuda())})
    if not dual:
        want, got = {"": want}, {"": got}
    scores = max(float((got[k].cpu() - want[k]).abs().max()) for k in want)
    out = []
    for model in (cpu, card):
        model.module.double()
        opt, lr_fn = construct_optimizer(cfg, model.module, 4)
        # the gradients before the optimizer's step: CUDA's foreach SGD
        # adds the Nesterov momentum into .grad in place where a group has
        # no weight decay
        grads = {}
        opt.register_step_pre_hook(lambda *_, m=model: grads.update(
            {k: p.grad.cpu().clone() for k, p in m.module.named_parameters()}))
        metrics = make_train_step(model, cfg, opt, lr_fn)(
            create_train_state(model, opt),
            {k: v.to(model.device) for k, v in batch.items()})
        stats = torch.cat([v.flatten().cpu() for k, v in
                           model.module.state_dict().items()
                           if k.endswith("running_var")
                           or k.endswith("running_mean")]
                          + [torch.zeros(0, dtype=torch.float64)])
        assert all(g.dtype == torch.float64 for g in grads.values())
        out.append(({k: float(v) for k, v in metrics.items()}, stats, grads))
    (mc, sc, gc), (mg, sg, gg) = out
    grads, worst = _worst_leaf(gg, gc)
    return {"scores": scores,
            "loss": abs(mg["loss"] - mc["loss"]) / abs(mc["loss"]),
            "stats": _rel_l2(sg, sc) if sc.numel() else 0.0, "grads": grads,
            "worst": worst}, \
        set(mc), set(mg)


@pytest.mark.parametrize("name", list(CONV_TINY))
def test_tiny_conv_family_on_the_card_matches_the_cpu(name):
    """A tiny SlowFast with ``SlowFastHeadx2``, ir-CSN with ``BaseHeadx2``
    (both with the verb/noun labels, so the dual-label step) and S3D-G
    with ``BaseHead``: eval scores, then one SGD step in float64, on the
    card against the CPU from the same weights; K1-K4 launch no time."""
    counts = (att.fused_attention_qkv, att.attention_qkv_rows,
              tn.fused_temporal_net, tn.fused_temporal_net_bwd)
    for fn in counts:
        fn.launches = 0
    reading, cpu_metrics, card_metrics = tiny_conv_readings(name)
    assert cpu_metrics == card_metrics
    if name != "s3dg":
        assert {"top1_err_verb", "top5_err_noun",
                "loss_verb_class"} <= card_metrics
    assert reading["scores"] <= CONV_SCORE_ATOL, reading
    assert reading["loss"] <= CONV_LOSS_RTOL, reading
    assert reading["stats"] <= CONV_STATS_REL, reading
    assert reading["grads"] <= CONV_GRAD_REL, reading
    assert all(fn.launches == 0 for fn in counts)


# a tiny TimeSformer (divided attention) and a tiny TAda-ConvNeXt (the
# avg-pool variant, layer scale 0.5 so that every block counts), both
# without stochastic depth, at their train crop: the limits of the conv
# family above
TRANSFORMER_TINY = {
    "timesformer": ("configs/pool/backbone/timesformer.yaml",
                    ["VIDEO.BACKBONE.NUM_FEATURES", "64",
                     "VIDEO.BACKBONE.NUM_HEADS", "2", "VIDEO.BACKBONE.DEPTH",
                     "2", "VIDEO.BACKBONE.PATCH_SIZE", "8",
                     "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE",
                     "32", "VIDEO.HEAD.NUM_CLASSES", "7"], 2),
    "tada_convnext": ("configs/pool/backbone/tada_convnext_tiny.yaml",
                      ["VIDEO.BACKBONE.NUM_FILTERS", "[8, 16, 32, 64]",
                       "VIDEO.BACKBONE.DEPTH", "[1, 1, 2, 1]",
                       "VIDEO.BACKBONE.BRANCH.NAME",
                       "TAdaConvNeXtBlockAvgPoolGELU",
                       "VIDEO.BACKBONE.LARGE_SCALE_INIT_VALUE", "0.5",
                       "VIDEO.BACKBONE.DROP_PATH", "0.0",
                       "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE",
                       "64", "DATA.TEST_CROP_SIZE", "64",
                       "VIDEO.HEAD.NUM_CLASSES", "7"], 2),
}


@pytest.mark.parametrize("name", list(TRANSFORMER_TINY))
def test_tiny_transformers_on_the_card_match_the_cpu(name):
    """The tiny TimeSformer and TAda-ConvNeXt: eval scores, then one Adam
    step in float64, on the card against the CPU from the same weights,
    within the conv family's limits; K1-K4 launch no time."""
    counts = (att.fused_attention_qkv, att.attention_qkv_rows,
              tn.fused_temporal_net, tn.fused_temporal_net_bwd)
    for fn in counts:
        fn.launches = 0
    reading, cpu_metrics, card_metrics = tiny_conv_readings(
        name, TRANSFORMER_TINY)
    assert cpu_metrics == card_metrics
    assert reading["scores"] <= CONV_SCORE_ATOL, reading
    assert reading["loss"] <= CONV_LOSS_RTOL, reading
    assert reading["stats"] <= CONV_STATS_REL, reading
    assert reading["grads"] <= CONV_GRAD_REL, reading
    assert all(fn.launches == 0 for fn in counts)


@pytest.mark.parametrize("sides", [(7, 8), (8, 7), (4, 6)])
def test_position_table_resize_on_the_card(sides):
    """``resize_grid`` on the card equals the CPU's within fp32 rounding,
    growing (ViT-S's 7 -> 8) and shrinking (antialiased)."""
    from dist_tpu_torch.models.backbones.video_transformer import resize_grid

    s0, s1 = sides
    grid = torch.randn((16, s0, s0, 384),
                       generator=torch.Generator().manual_seed(s0 + s1))
    want = resize_grid(grid, s1)
    got = resize_grid(grid.cuda(), s1)
    assert got.shape == (16, s1, s1, 384) and got.is_cuda
    _within(got.cpu(), want, atol=1e-6, rtol=1e-6)


# SSL pretraining: the device augmentation's apply on the card against the
# CPU on the same factors (fp32, values in [0, 1]; chip_smoke.py's
# SSL_AUG_LIMIT), and one float64 SSL step of the S3D-G configs, card
# against CPU, within the conv family's limits
SSL_AUG_LIMIT = 5e-5
SSL_TINY = {
    "hico": ("configs/projects/hico/pt-k400/s3dg-hico-l.yaml", 3),
    "hico_pp": ("configs/projects/hico++/pt-k400/s3dg-hico++m6.yaml", 4),
}
SSL_TINY_OPTS = ["DATA.NUM_INPUT_FRAMES", "8", "DATA.TRAIN_CROP_SIZE", "32",
                 "DATA.TEST_CROP_SIZE", "32", "DATA.TEST_SCALE", "32",
                 "PRETRAIN.CONTRASTIVE.HEAD_MID_DIM", "64",
                 "PRETRAIN.CONTRASTIVE.HEAD_OUT_DIM", "32"]


def _ssl_cfg(path, *opts):
    import os

    from dist_tpu_torch.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(os.path.join(repo, path), list(opts),
                       make_output_dir=False)


def test_ssl_device_augment_on_the_card_matches_the_cpu():
    from dist_tpu_torch.ops import augment_device as pa
    from dist_tpu_torch.tasks.state import augment_draws

    cfg = _ssl_cfg(SSL_TINY["hico"][0])
    c = pa.DeviceAugConfig.from_cfg(cfg)
    gen = torch.Generator().manual_seed(3)
    video = torch.rand((16, 8, 56, 56, 3), generator=gen)
    f = augment_draws(c, 16, 5, 2)
    want = pa.apply(video, f, c)
    got = pa.apply(video.cuda(), f, c)
    assert got.is_cuda
    assert float((got.cpu() - want).abs().max()) <= SSL_AUG_LIMIT
    flipped = pa.apply(video.cuda(), {**f, "flip": ~f["flip"]}, c)
    assert float((flipped.cpu() - want).abs().max()) > SSL_AUG_LIMIT


@pytest.mark.parametrize("name", list(SSL_TINY))
def test_tiny_ssl_step_on_the_card_matches_the_cpu(name):
    """One float64 SSL step (S3D-G at 8 x 32^2, its contrastive head
    narrowed, LARS) on 2 videos of normalised views, card against CPU from
    the same weights: the loss, the running stats and the worst gradient
    leaf within the conv family's limits; K1-K4 launch no time."""
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import LARS, construct_optimizer
    from dist_tpu_torch.tasks.state import (
        _prep_video,
        create_train_state,
        make_train_step,
    )

    counts = (att.fused_attention_qkv, att.attention_qkv_rows,
              tn.fused_temporal_net, tn.fused_temporal_net_bwd)
    for fn in counts:
        fn.launches = 0
    path, views = SSL_TINY[name]
    cfg = _ssl_cfg(path, *SSL_TINY_OPTS, "PRETRAIN.NUM_CLIPS_PER_VIDEO",
                   str(views))
    gen = torch.Generator().manual_seed(4)
    clips = torch.randint(0, 256, (2 * views, 8, 32, 32, 3), generator=gen,
                          dtype=torch.int32).to(torch.uint8)
    video = _prep_video(cfg, clips).double()
    batch = {"video": video.reshape((2, views) + tuple(video.shape[1:])),
             "labels": torch.zeros(2, dtype=torch.long),
             "contrastive": torch.arange(views).repeat(2, 1)}
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    card.module.load_state_dict(cpu.module.state_dict())
    out = []
    for model in (cpu, card):
        model.module.double()
        opt, lr_fn = construct_optimizer(cfg, model.module, 4)
        assert isinstance(opt, LARS)
        grads = {}
        opt.register_step_pre_hook(lambda *_, m=model: grads.update(
            {k: p.grad.cpu().clone() for k, p in m.module.named_parameters()}))
        metrics = make_train_step(model, cfg, opt, lr_fn)(
            create_train_state(model, opt),
            {k: v.to(model.device) for k, v in batch.items()})
        stats = torch.cat([v.flatten().cpu() for k, v in
                           model.module.state_dict().items()
                           if k.endswith(("running_var", "running_mean"))])
        out.append((float(metrics["loss"]), stats, grads))
    (lc, sc, gc), (lg, sg, gg) = out
    assert abs(lg - lc) / abs(lc) <= CONV_LOSS_RTOL
    assert _rel_l2(sg, sc) <= CONV_STATS_REL
    assert _worst_leaf(gg, gc)[0] <= CONV_GRAD_REL, _worst_leaf(gg, gc)
    assert all(fn.launches == 0 for fn in counts)


# BMN (bmn_epic100.yaml) at a tiny geometry: 20 snippets of 48 features,
# DIM1D 16, DSCALE 10, four groups, verb/noun maps [6, 9]
BMN_TINY = ["DATA.NUM_INPUT_CHANNELS", "48", "DATA.NUM_INPUT_FRAMES", "20",
            "VIDEO.DIM1D", "16", "LOCALIZATION.DSCALE", "10",
            "VIDEO.HEAD.NUM_CLASSES", "[6, 9]",
            "LOCALIZATION.LOSS", "Tem+PemReg+PemCls+BmnActionCls",
            "LOCALIZATION.LOSS_WEIGHTS", "[1.0, 10.0, 1.0, 1.0]"]
# fp32 card against CPU, TF32 off: every output of the tiny BMN
BMN_FORWARD_ATOL = 1e-5


def _bmn_batch(b, seed, t=20, c=48, d=10):
    gen = torch.Generator().manual_seed(seed)
    valid = ((torch.arange(t)[None, :] + torch.arange(1, d + 1)[:, None])
             <= t).double().expand(b, d, t)
    labels = {"start_map": (torch.rand(b, t, generator=gen) > 0.7).double(),
              "end_map": (torch.rand(b, t, generator=gen) > 0.7).double(),
              "iou_map": torch.rand(b, d, t, generator=gen).double() * valid,
              "mask": valid.contiguous(),
              "label_map": torch.stack(
                  [torch.randint(0, n, (b, d, t), generator=gen)
                   for n in (6, 9)], 1)}
    return torch.randn(b, t, c, generator=gen), labels


def test_tiny_bmn_on_the_card_matches_the_cpu():
    """The tiny BMN's forward in fp32 and one float64 Adam step with all
    four losses (``Loss_PemReg``'s draws from the CPU generator on both),
    card against CPU from the same weights: outputs within
    ``BMN_FORWARD_ATOL``, the loss and the worst gradient leaf within the
    conv family's limits; K1-K4 launch no time."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    counts = (att.fused_attention_qkv, att.attention_qkv_rows,
              tn.fused_temporal_net, tn.fused_temporal_net_bwd)
    for fn in counts:
        fn.launches = 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs/projects/tal/bmn_epic100.yaml"),
                      BMN_TINY, make_output_dir=False)
    feats, labels = _bmn_batch(2, 5)
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    card.module.load_state_dict(cpu.module.state_dict())
    with torch.no_grad():
        want, _ = cpu.apply({"video": feats})
        got, _ = card.apply({"video": feats.cuda()})
    for k in want:
        _within(got[k].cpu(), want[k], BMN_FORWARD_ATOL, 0.0)
    out = []
    for model in (cpu, card):
        model.module.double()
        opt, lr_fn = construct_optimizer(cfg, model.module, 4)
        grads = {}
        opt.register_step_pre_hook(lambda *_, m=model: grads.update(
            {k: p.grad.cpu().clone() for k, p in m.module.named_parameters()}))
        batch = {"video": feats.double().to(model.device),
                 "labels": {k: v.to(model.device) for k, v in labels.items()}}
        metrics = make_train_step(model, cfg, opt, lr_fn)(
            create_train_state(model, opt), batch)
        out.append((float(metrics["loss"]), grads))
    (lc, gc), (lg, gg) = out
    assert abs(lg - lc) / abs(lc) <= CONV_LOSS_RTOL
    assert _worst_leaf(gg, gc)[0] <= CONV_GRAD_REL, _worst_leaf(gg, gc)
    assert all(fn.launches == 0 for fn in counts)


def test_tiny_submission_on_the_card(tmp_path):
    """The tiny DiST config's submission run list on the card (K1 and K2
    fused): 10 x 3 views of 2 synthetic videos through both kernels, the
    generic JSON with each video's 30 softmax views summed."""
    import json
    import os

    from dist_tpu_torch import run

    for fn in (att.fused_attention_qkv, tn.fused_temporal_net):
        fn.launches = 0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    (path,) = run.main([
        "--cfg", os.path.join(repo, "configs/projects/dist/test/tiny_synth.yaml"),
        "TASK_TYPE", "submission", "SUBMISSION.ENABLE", "true",
        "TPU.FUSED_TEMPORAL_NET", "true", "TEST.NUM_SAMPLES_LIMIT", "2",
        "TEST.BATCH_SIZE", "16", "OUTPUT_DIR", str(tmp_path)])
    with open(path) as f:
        results = json.load(f)
    assert results["version"] == "0.1" and sorted(results["results"]) == ["0", "1"]
    for entry in results["results"].values():
        scores = np.asarray(entry["scores"])
        assert np.isfinite(scores).all()
        np.testing.assert_allclose(scores.sum(), 30.0, rtol=1e-3)
    assert att.fused_attention_qkv.launches > 0
    assert tn.fused_temporal_net.launches > 0


def test_process_pool_loader_beside_the_card():
    """With CUDA initialised in this process, a spawned process pool
    (RandAugment and random erasing on, the twins of OpenCV's ops) yields
    the thread pool's train batches bit for bit."""
    import os

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.data.builder import build_loader

    torch.zeros(1, device="cuda")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opts = ["AUGMENTATION.AUTOAUGMENT.ENABLE", "true",
            "AUGMENTATION.RANDOM_ERASING.ENABLE", "true",
            "TRAIN.BATCH_SIZE", "4", "TRAIN.NUM_SAMPLES_LIMIT", "8"]
    batches = {}
    for worker_type in ("process", "thread"):
        cfg = load_config(os.path.join(
            repo, "configs/projects/dist/test/tiny_synth.yaml"),
            opts + ["DATA_LOADER.WORKER_TYPE", worker_type],
            make_output_dir=False)
        loader = build_loader(cfg, "train", device="cuda")
        try:
            batches[worker_type] = list(loader)
        finally:
            loader.close()
    assert len(batches["process"]) == len(batches["thread"]) == 2
    for g, w in zip(batches["process"], batches["thread"]):
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))


# K1b, the attention backward: (B, L, heads, head dim) over the lengths
# of the vision towers and the text tower, L = 1 and 17 (pad rows in the
# last 64-row tile), a length past the whole-row lengths, and every head
# dim the kernel takes
BWD_SHAPES = [(4, 197, 12, 64), (6, 77, 8, 64), (2, 257, 16, 64),
              (3, 1, 2, 64), (3, 17, 4, 16), (2, 130, 2, 32),
              (2, 65, 2, 128), (2, 577, 4, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_attention_bwd_kernel_matches_plain(shape, causal, dtype):
    """K1b against ``attention_qkv_bwd_plain`` within
    ``tools/attn_bwd.py::BWD_LIMITS``, which the control (the rowsum term
    of dS dropped) must break; two launches bit for bit; one count a
    call."""
    from dist_tpu_torch.tools import attn_bwd

    b, l, h, hd = shape
    qkv, dout = attn_bwd.inputs(b, l, h, hd, getattr(torch, dtype),
                                seed=l * h + causal)
    before = att.attention_qkv_bwd.launches
    rec = attn_bwd.reading(qkv, dout, h, causal)
    torch.cuda.synchronize()
    assert att.attention_qkv_bwd.launches == before + 2
    assert rec["again_equal"]
    assert max(rec["kernel_err"]) <= rec["limit"], rec
    if l > 1:       # at L = 1 dS is 0 with or without the rowsum term
        assert max(rec["control_err"]) > rec["limit"], rec


def test_attention_bwd_pad_rows_are_zero_filled():
    """A launch on NaN inputs first leaves NaN in the SMs' shared memory;
    the short rows after it must still come out finite and right."""
    from dist_tpu_torch.tools import attn_bwd

    nan = torch.full((16, 197, 3 * 4 * 64), float("nan"), device="cuda",
                     dtype=torch.bfloat16)
    att.attention_qkv_bwd(nan, nan[..., :4 * 64].contiguous(), 4)
    qkv, dout = attn_bwd.inputs(16, 17, 4, 64, torch.bfloat16, seed=17)
    for causal in (False, True):
        rec = attn_bwd.reading(qkv, dout, 4, causal)
        assert max(rec["kernel_err"]) <= rec["limit"], rec


def test_attention_bwd_through_autograd_on_the_card():
    """``torch.autograd.grad`` of ``fused_attention_qkv`` on a CUDA tensor
    launches K1 once and K1b once, and gives K1b's gradients."""
    from dist_tpu_torch.tools import attn_bwd

    qkv, dout = attn_bwd.inputs(4, 197, 12, 64, torch.bfloat16, seed=9)
    x = qkv.clone().requires_grad_()
    f0, b0 = att.fused_attention_qkv.launches, att.attention_qkv_bwd.launches
    (g,) = torch.autograd.grad(att.fused_attention_qkv(x, 12), x, dout)
    assert (att.fused_attention_qkv.launches - f0,
            att.attention_qkv_bwd.launches - b0) == (1, 1)
    assert torch.equal(g, att.attention_qkv_bwd(qkv, dout, 12))


def test_attention_bwd_kernel_refuses_what_it_cannot_take():
    x = torch.zeros((2, 5, 3 * 2 * 64), device="cuda", dtype=torch.bfloat16)
    do = torch.zeros((2, 5, 2 * 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):                     # head dim 48
        att.attention_qkv_bwd(torch.zeros((2, 5, 3 * 2 * 48), device="cuda"),
                              torch.zeros((2, 5, 2 * 48), device="cuda"), 2)
    with pytest.raises(ValueError):                     # dout fp32
        att.attention_qkv_bwd(x, do.float(), 2)
    with pytest.raises(ValueError):                     # dout on the CPU
        att.attention_qkv_bwd(x, do.cpu(), 2)
    with pytest.raises(ValueError):                     # not contiguous
        att.attention_qkv_bwd(
            x, torch.zeros((5, 2, 128), device="cuda",
                           dtype=torch.bfloat16).transpose(0, 1), 2)
    flat = torch.zeros(1 + 2 * 5 * 128, device="cuda")
    with pytest.raises(ValueError):                     # not 16-byte aligned
        att.attention_qkv_bwd(x.float(), flat[1:].view(2, 5, 128), 2)
    with pytest.raises(ValueError, match=r"\(1, 1025, 192\)"):  # L > 1024
        att.attention_qkv_bwd(
            torch.zeros((1, 1025, 192), device="cuda"),
            torch.zeros((1, 1025, 64), device="cuda"), 1)
    for hd in (16, 32, 64, 128):
        for dt in (torch.float32, torch.bfloat16):
            assert min(att.bwd_blocks_per_sm(hd, dt).values()) >= 1


# K1b's route sweep: the lengths at the edges of the routes at batch 4, 4
# heads, hd 64 (77 causal, as the text tower), and hd 16 and 32 at L 197
BWD_ROUTE_CASES = ([(l, 64, l == 77) for l in ROUTE_EDGE_LENGTHS]
                   + [(197, 16, False), (197, 32, False)])


@pytest.mark.parametrize("l,hd,causal", BWD_ROUTE_CASES)
def test_attention_bwd_route_sweep(l, hd, causal):
    """K1b in bf16 on the rule's route (whole_row to L 272, streaming
    past it): the same bits as a launch named with that route, two
    launches bit for bit, within ``BWD_LIMITS``, the control outside them
    (but at L = 1, where dS is 0 with or without the rowsum term)."""
    from dist_tpu_torch.tools import attn_bwd

    qkv, dout = attn_bwd.inputs(4, l, 4, hd, torch.bfloat16, seed=l + hd)
    rec = attn_bwd.reading(qkv, dout, 4, causal)
    assert rec["route"] == ("whole_row" if l <= 272 else "streaming")
    named = torch.empty_like(qkv)
    att.bwd_launch(qkv, dout, named, torch.empty((3, 4, 4, l), device="cuda"),
                   4, causal, rec["route"])
    assert torch.equal(named, att.attention_qkv_bwd(qkv, dout, 4, causal))
    assert rec["again_equal"]
    assert max(rec["kernel_err"]) <= rec["limit"], rec
    if l > 1:
        assert max(rec["control_err"]) > rec["limit"], rec


def test_attention_bwd_streaming_route_on_request_and_refused_routes():
    """The private ``_route="streaming"`` runs the streaming kernel
    where the rule says whole_row, within the same limits; the kernel
    refuses a route the rule does not name."""
    from dist_tpu_torch.tools import attn_bwd

    qkv, dout = attn_bwd.inputs(4, 197, 12, 64, torch.bfloat16, seed=12)
    before = att.attention_qkv_bwd.launches
    got = att.attention_qkv_bwd(qkv, dout, 12, _route="streaming")
    again = att.attention_qkv_bwd(qkv, dout, 12, _route="streaming")
    assert att.attention_qkv_bwd.launches == before + 2
    want = att.attention_qkv_bwd_plain(qkv, dout, 12)
    limit = attn_bwd.BWD_LIMITS["bfloat16"]
    assert torch.equal(got, again)
    assert max(attn_bwd.thirds_err(got, want)) <= limit
    assert max(attn_bwd.thirds_err(attn_bwd.bwd_without_rowsum(
        qkv, dout, 12), want)) > limit
    x, do = attn_bwd.inputs(1, 273, 1, 64, torch.bfloat16, seed=1)
    with pytest.raises(RuntimeError):                  # whole_row at L 273
        att.attention_qkv_bwd(x, do, 1, _route="whole_row")
    with pytest.raises(RuntimeError):                  # whole_row in fp32
        att.attention_qkv_bwd(x[:, :77].float().contiguous(),
                              do[:, :77].float().contiguous(), 1,
                              _route="whole_row")
    with pytest.raises(ValueError):
        att.attention_qkv_bwd(qkv, dout, 12, _route="fast")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [77, 197, 257])
def test_attention_bwd_whole_row_occupancy(l, causal):
    """Both passes of K1b's whole-row instances at hd 64 keep two blocks
    on an SM, pass dkv three up to LP 208 (it holds no K or V tile)."""
    assert att.attention_bwd_route(l, 64, torch.bfloat16) == "whole_row"
    blocks = att.bwd_blocks_per_sm(64, torch.bfloat16, l, causal=causal)
    lp = next(p for p in att.WHOLE_ROW_LENS if l <= p)
    assert blocks["dq"] >= 2
    assert blocks["dkv"] >= (3 if lp <= 208 else 2)
    smem = att.bwd_smem_bytes(64, torch.bfloat16, l)
    assert smem == {"dq": (128 + 2 * lp) * 72 * 2,
                    "dkv": 2 * lp * 72 * 2 + 12 * lp}


def _clip_ft_cfg(*opts):
    import os

    from dist_tpu_torch.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_config(
        os.path.join(repo, "configs/projects/dist/vit_base_16_ssv2.yaml"),
        ["VIDEO.HEAD.NAME", "ClipVideoHeadLinear",
         "VIDEO.BACKBONE.META_ARCH_NAME", "ViT-Test",
         "DATA.NUM_INPUT_FRAMES", "4", "DATA.TRAIN_CROP_SIZE", "64",
         "TRAIN.MIXED_PRECISION", "false", "AUGMENTATION.MIXUP.ENABLE",
         "false", "AUGMENTATION.CUTMIX.ENABLE", "false",
         "VIDEO.HEAD.DROPOUT_RATE", "0", *opts], make_output_dir=False)


def _clip_ft_step(cfg, device, batch):
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    model = build_model(cfg, device=device)
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    batch = {k: v.to(device) for k, v in batch.items()}
    loss = float(step(create_train_state(model, optimizer), batch)["loss"])
    return loss, {k: p.grad.detach().cpu() for k, p in
                  model.module.named_parameters() if p.requires_grad}, model


def _clip_ft_batch():
    rng = np.random.default_rng(4)
    return {"video": torch.from_numpy(rng.integers(
                0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)),
            "labels": torch.tensor([3, 170])}


@pytest.mark.parametrize("remat", ["false", "true"])
def test_tiny_clip_ft_step_on_the_card_matches_the_cpu(remat):
    """One fp32 step of the tiny CLIP fine-tune (the whole vision tower
    and the linear head train) on the card against the CPU: K1 2 a step
    (4 with remat) and K1b 2; the loss within 1e-5 relative and every
    gradient within 1e-4 of its tensor's largest (fp32, K1 and K1b's fp32
    routes against their plain versions, sums in another order); the
    text tower's gradient 0 on both."""
    cfg = _clip_ft_cfg("TPU.REMAT", remat)
    f0, b0 = att.fused_attention_qkv.launches, att.attention_qkv_bwd.launches
    loss, grads, _ = _clip_ft_step(cfg, "cuda", _clip_ft_batch())
    assert (att.fused_attention_qkv.launches - f0,
            att.attention_qkv_bwd.launches - b0) == (
                4 if remat == "true" else 2, 2)
    want_loss, want, module = _clip_ft_step(cfg, "cpu", _clip_ft_batch())
    assert loss == pytest.approx(want_loss, rel=1e-5)
    for k, g in want.items():
        top = float(g.abs().max())
        if module.module.is_text_param(k) or k == "logit_scale":
            assert top == 0 and float(grads[k].abs().max()) == 0, k
            continue
        assert top > 0, k
        assert float((grads[k] - g).abs().max()) <= 1e-4 * top, k


def test_tiny_clip_ft_step_with_remat_equals_without_on_the_card():
    """The same step with ``TPU.REMAT`` and without, on the card: the loss
    and every gradient bit for bit."""
    out = [_clip_ft_step(_clip_ft_cfg("TPU.REMAT", r), "cuda",
                         _clip_ft_batch())[:2] for r in ("true", "false")]
    assert out[0][0] == out[1][0]
    for k, g in out[1][1].items():
        assert torch.equal(out[0][1][k], g), k
