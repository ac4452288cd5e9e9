#!/usr/bin/env python3
"""Drive the PyTorch port (``dist_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Card: prints the card's name and power limit, builds the hand-written
   CUDA kernels from ``dist_tpu_torch/csrc`` with nvcc (in parallel) and
   fails if ptxas reports spill bytes for any whole-row attention
   instance or any instance of K3's bf16 route.
2. Kernels: calls each kernel on the card at the shapes the serving path
   and the train step give it (K3, the TemporalNet backward, in fp32 on the
   CUDA cores and in bf16 on the tensor cores, twice, to show that two
   launches agree bit for bit) and holds it against its plain PyTorch
   version on the same inputs (TF32 off), with the tolerance stated beside
   each check (K3 bf16: per-output limits, ``BWD_BF16_LIMITS``, that a
   control with one spatial tap dropped must break); times the kernel, the plain
   version and, where one PyTorch call computes the same function, that
   call (``library_ms``), with CUDA events after warm-up.
3. Serving: builds ``InferenceEngine`` for the DiST ViT-B/16 8+16f SSV2
   config at full width (174 classes, ``TPU.FUSED_TEMPORAL_NET true``,
   batch size 8, weights made from ``RANDOM_SEED``), warms it up and
   answers requests of 1, 3 and 8 seeded random uint8 clips; checks the
   scores and that every request batch went through both kernels (launch
   counts zeroed just before, read just after).
4. Agreement: for each of three weight seeds, one request of the served
   model against the same model with the unfused TemporalNet on the card
   and against the same weights on the CPU through the plain versions
   (both bf16, as served), and the card against the CPU with both in
   fp32, held to ``AGREEMENT_LIMITS``; controls (the unfused model with
   one of K2's spatial taps dropped) must break those limits.
5. Train: the same config's train step at full width (batch 32,
   bf16, AdamW with the DiST groups, cosine LR with warmup, mixup/cutmix,
   label smoothing, ``TPU.FUSED_TEMPORAL_NET true``): 2 warm-up and 5
   timed steps on seeded uint8 clips. Checks finite losses, that every
   dist_net parameter with a gradient moved and every frozen one did not,
   and the launches per step (K1 12 in the frozen vision tower, K2 12,
   K3 12); K1's 12 text-tower launches at set-up are counted apart. Then
   times 3 steps with the unfused TemporalNet beside them.
6. Train agreement: for three weight seeds, one step's dist_net gradients
   and loss (mixup off) of the fused path against the unfused path (cuDNN
   convs), both bf16 on the card at batch 32, and of the card against the
   CPU plain versions, both fp32 at batch 2, held to
   ``TRAIN_AGREEMENT_LIMITS``; a control with one spatial tap of the first
   block dropped must break them.
7. Tools, at full width (launch counts zeroed just before, read just
   after the in-process part): ``microbench attn`` in this process (REPS
   small, stdout captured): every variant has ``ms`` and no ``error``, and
   K4 (``attn_rows{2,4,8}``) lies within the bf16 tolerance of K1; an HTTP
   round trip through ``VideoClassifierServer`` (flagship, batch 8, port
   0): 3 clips POSTed from 3 threads, health and stats read, every
   returned top-k score within ``HTTP_SCORE_LIMIT`` of the engine's own
   ``predict`` of the clip, a bad payload answered 400. Then, each as a
   subprocess with its own timeout, its exit code checked and every JSON
   line parsed: ``microbench conv33``, ``tools.bench`` (eval and train
   clips/s), ``tools.bench_serving`` and ``tools.profile_eval full_eval
   attn_kernel``.

The kernel checks (2) include K4, the multi-row attention, at nb = 2, 4
and 8 in bf16 and nb = 8 in fp32 at (64, 197, 2304): two launches bit for
bit, equal to K1 bit for bit, K1's time on the same input beside it, and
``B % nb != 0`` refused. Each attention check names its route
(``attention_route``: whole_row, streaming or fp32) and the blocks per SM;
at the train shape K1's streaming kernel is timed on the same input
(``streaming_ms``), and at L = 577 (ViT-L/14 at 336 px) it is the route. A bf16 sweep at batch 4, 4 heads holds K1 to its plain
version at the lengths on the edges of the routes (``ROUTE_EDGE_LENGTHS``).

Prints one JSON line per check and phase, then ``{"kernels": [...]}`` (the
numbers of each kernel at the train step's shapes, launches from the train
phase, the serving shapes' numbers beside them; K4's from the tools phase
at nb = 8, each nb's beside them; K1 and K4 with their attention route,
blocks per SM and the ptxas registers and spill bytes of the instance the
main path launches), the card line, and last
``{"ok": true, "device": {...}}``. Any failure, or no CUDA card, exits
non-zero without the last line.
"""

import json
import math
import os
import subprocess
import sys
import time
import traceback

FLAGSHIP = "configs/projects/dist/ssv2/vit-b16-8+16f.yaml"
PEAK_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,   # dense tensor-core rate
              "float32": 67e12}     # fp32 outside the tensor cores
SERVE_REQUESTS = (1, 3, 8)
TIMED_REPEATS = 10
# the card's busy wait before a timed run: ~10 ms at the H100's ~2 GHz,
# longer than the host takes to queue 20 launches
HOLD_CYCLES = 20_000_000
AGREEMENT_SEEDS = 3                 # weight seeds RANDOM_SEED + 0, 1, 2
AGREEMENT_CLIPS = 3                 # clips per agreement request
# controls: TemporalNet blocks (from the first) with one spatial tap
# dropped; applied in this order to one model, each on top of the last
CONTROLS = {"skip_tap_first_block": 1, "skip_tap_every_block": None}
# the control that every bf16 comparison must reject; one block's skipped
# tap moves the embedding no more than bf16 rounding does (1 - cos ~1.3e-5
# against up to 2.1e-5), so only the kernel checks and fp32 see it
CONTROL_MUST_BREAK = "skip_tap_every_block"
# Limits: 3 times the worst reading of seeds 0-2 on an H100 (score,
# logit, 1 - cosine), and below the every-block control where one can be:
#   unfused_card  1.64e-5  0.0082  1.11e-5
#   cpu           2.33e-5  0.0105  2.12e-5  (text 1 - cos 7.0e-5)
#   fp32          3.7e-9   1.07e-6 1.7e-13
#   control, every block:  3.8e-5 - 5.5e-5, 0.010 - 0.024, 1.5e-4 - 2.8e-4
# The control's scores and logits lie within the bf16 limits; its cosine
# breaks them by 2.4 times or more.
AGREEMENT_LIMITS = {
    "unfused_card": {"max_abs_score_diff": 5e-5, "max_abs_logit_diff": 0.025,
                     "min_embedding_cosine": 1 - 3.4e-5},
    "cpu": {"max_abs_score_diff": 7e-5, "max_abs_logit_diff": 0.032,
            "min_embedding_cosine": 1 - 6.4e-5,
            "min_text_cosine": 1 - 2.1e-4},
    "fp32_card_vs_cpu": {"max_abs_score_diff": 1.1e-8,
                         "max_abs_logit_diff": 3.2e-6,
                         "min_embedding_cosine": 1 - 5e-13},
}

# the schedule's epoch length: SSV2's 168,913 training clips at batch 32
TRAIN_STEPS_PER_EPOCH = 5279
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 5
TRAIN_AGREEMENT_CPU_CLIPS = 2       # batch of the card-against-CPU reading
# the control: the unfused model with the (0, 0) tap of the 3x3 spatial
# conv dropped in the first TemporalNet; it must break the limits of both
# comparisons
TRAIN_CONTROL_BLOCKS = 1
# Limits on one step's dist_net gradients: the worst relative L2 error
# ||a - b|| / ||b|| and the least cosine over the 381 parameter tensors
# with a gradient, and the loss's relative difference. 3 times the worst
# reading of seeds 0-2 on an H100 (grad error, 1 - cosine, loss):
#   unfused_card_bf16  0.0340   5.76e-4  3.96e-5
#   cpu_fp32           6.58e-6  2.09e-11 1.90e-7
#   control, bf16      0.326 - 0.332, 0.052 - 0.057, 6.4e-6 - 2.9e-5
#   control, fp32      0.279 - 0.393, 0.039 - 0.077, 8.4e-6 - 4.5e-5
# The bf16 control breaks the gradient limits by 3.2 times or more; its
# loss lies inside the bf16 noise.
TRAIN_AGREEMENT_LIMITS = {
    "unfused_card_bf16": {"max_grad_rel_err": 0.102,
                          "min_grad_cosine": 1 - 1.73e-3,
                          "loss_rel_diff": 1.2e-4},
    "cpu_fp32": {"max_grad_rel_err": 2e-5, "min_grad_cosine": 1 - 6.3e-11,
                 "loss_rel_diff": 5.8e-7},
}


# the tools phase: microbench repetitions, each tool subprocess's time
# limit, and the HTTP round trip's limit on a returned score against the
# engine's own predict of the clip (the serving agreement's score limit)
TOOLS_REPS = 3
TOOL_TIMEOUT_S = 300
HTTP_CLIPS = 3
HTTP_SCORE_LIMIT = AGREEMENT_LIMITS["unfused_card"]["max_abs_score_diff"]
# K3's bf16 route (bf16 product operands, fp32 sums and elementwise steps)
# against its fp32 plain version, per output: max |err| / max |ref| and
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
K4_ROWS = (2, 4, 8)
# K1's bf16 route sweep: the lengths at the edges of the routes (the
# whole-row instances pad L to 80, 208 and 272; longer rows stream), 77
# causal as in the text tower, at hd 64, and one length at hd 32
ROUTE_EDGE_LENGTHS = (1, 16, 17, 77, 80, 81, 197, 208, 209, 257, 272, 273)
ROUTE_SWEEP_HD32_LEN = 197
ROUTE_SWEEP_BATCH = 4
ROUTE_SWEEP_HEADS = 4


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters):
    """Mean time of one call, CUDA events around ``iters`` calls after
    warm-up. The card is first held busy for ``HOLD_CYCLES`` clock cycles,
    so that the host has queued every timed call before the first runs: the
    events then time the card, not the host's pace of launches."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes, flops, dtype_name):
    """Least time in ms for the work: the larger of bytes over the memory
    rate and operations over the peak rate of their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(got, want, atol, rtol):
    """max |got - want| and whether every element is within
    atol + rtol * |want|."""
    import torch

    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), False
    err = (g - w).abs()
    return float(err.max()), bool((err <= atol + rtol * w.abs()).all())


def check_attention(name, b, l, heads, hd, causal, dtype, seed,
                    streaming=False):
    """K1 against its plain version on its route; with ``streaming``, the
    streaming kernel's time on the same input beside it (the private route
    argument)."""
    import torch
    import torch.nn.functional as F
    from dist_tpu_torch.ops import attention as att

    d = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3 * d), generator=gen, device="cuda").to(dtype)
    got = att.fused_attention_qkv(qkv, heads, causal)
    want = att.attention_qkv_plain(qkv, heads, causal)
    torch.cuda.synchronize()
    atol, rtol, why = _attention_tolerance(qkv, d, dtype)
    err, ok = compare(got, want, atol, rtol)
    q, k, v = (qkv.view(b, l, 3, heads, hd)[:, :, i].transpose(1, 2)
               for i in range(3))
    dtname = str(dtype).split(".")[-1]
    pairs = l * (l + 1) // 2 if causal else l * l      # (query, key) pairs
    b_ms, b_by = bound(qkv.numel() * qkv.element_size()
                       + got.numel() * got.element_size(),
                       4 * b * heads * hd * pairs, dtname)
    rec = {
        "check": name, "kernel": "attention_qkv", "shape": [b, l, 3 * d],
        "heads": heads, "causal": causal, "dtype": dtname,
        "route": att.attention_route(l, hd, dtype),
        "blocks_per_sm": att.blocks_per_sm(l, hd, dtype, causal=causal),
        "max_abs_err": err, "atol": atol, "rtol": rtol, "tolerance": why,
        "ms": time_ms(lambda: att.fused_attention_qkv(qkv, heads, causal), 20),
        "plain_ms": time_ms(
            lambda: att.attention_qkv_plain(qkv, heads, causal), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20),
        "bound_ms": b_ms, "bound_by": b_by, "pass": ok,
    }
    if streaming:
        rec["streaming_ms"] = time_ms(lambda: att.fused_attention_qkv(
            qkv, heads, causal, _route="streaming"), 20)
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max abs err {err})")
    return rec


def check_route_sweep():
    """K1 in bf16 at small batch (B = 4, 4 heads) over the edges of its
    routes, each length held to the plain version under the bf16
    tolerance."""
    import torch
    from dist_tpu_torch.ops import attention as att

    cases, problems = [], []
    for l, hd, causal in [(l, 64, l == 77) for l in ROUTE_EDGE_LENGTHS] + [
            (ROUTE_SWEEP_HD32_LEN, 32, False)]:
        d = ROUTE_SWEEP_HEADS * hd
        gen = torch.Generator(device="cuda").manual_seed(l + hd)
        qkv = torch.randn((ROUTE_SWEEP_BATCH, l, 3 * d), generator=gen,
                          device="cuda").to(torch.bfloat16)
        got = att.fused_attention_qkv(qkv, ROUTE_SWEEP_HEADS, causal)
        want = att.attention_qkv_plain(qkv, ROUTE_SWEEP_HEADS, causal)
        torch.cuda.synchronize()
        atol, rtol, _ = _attention_tolerance(qkv, d, torch.bfloat16)
        err, ok = compare(got, want, atol, rtol)
        cases.append({"l": l, "hd": hd, "causal": causal,
                      "route": att.attention_route(l, hd, torch.bfloat16),
                      "max_abs_err": err, "atol": atol, "pass": ok})
        if not ok:
            problems.append(f"L={l} hd={hd}: max abs err {err}")
    emit({"check": "attention route sweep bf16", "kernel": "attention_qkv",
          "batch": ROUTE_SWEEP_BATCH, "heads": ROUTE_SWEEP_HEADS,
          "rtol": 2 ** -7, "tolerance": "bf16 rounding of P and O",
          "cases": cases, "pass": not problems})
    if problems:
        raise AssertionError("route sweep: " + "; ".join(problems))


def _attention_tolerance(qkv, d, dtype):
    """(atol, rtol, why) of an attention kernel against its plain
    version."""
    import torch

    if dtype == torch.float32:
        # fp32 on both sides; sums of <= 257 terms in another order
        return 2e-5, 1e-5, "fp32 summation order"
    # P is rounded to bf16 on both sides from fp32 values that may differ
    # in the last bit: a flip moves O by <= 2^-8 * max|V|; O itself is
    # rounded to bf16, one step <= 2^-7 relative
    vmax = float(qkv[..., 2 * d:].float().abs().max())
    return 2 ** -8 * vmax, 2 ** -7, "bf16 rounding of P and O"


def check_attention_rows(name, b, l, heads, hd, nb, dtype, seed):
    """K4 against its plain version: two launches bit for bit, equal to K1
    bit for bit, K1's time on the same input beside it, and ``B % nb != 0``
    refused."""
    import torch
    import torch.nn.functional as F
    from dist_tpu_torch.ops import attention as att

    d = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3 * d), generator=gen, device="cuda").to(dtype)
    got = att.attention_qkv_rows(qkv, heads, nb)
    again = att.attention_qkv_rows(qkv, heads, nb)
    want = att.attention_qkv_rows_plain(qkv, heads, nb)
    k1 = att.fused_attention_qkv(qkv, heads, False)
    torch.cuda.synchronize()
    atol, rtol, why = _attention_tolerance(qkv, d, dtype)
    err, ok = compare(got, want, atol, rtol)
    repeatable = bool(torch.equal(got, again))
    equal_k1 = bool(torch.equal(got, k1))
    try:
        att.attention_qkv_rows(qkv[:b - 1], heads, nb)
        refused = False
    except ValueError:
        refused = True
    q, k, v = (qkv.view(b, l, 3, heads, hd)[:, :, i].transpose(1, 2)
               for i in range(3))
    dtname = str(dtype).split(".")[-1]
    b_ms, b_by = bound(qkv.numel() * qkv.element_size()
                       + got.numel() * got.element_size(),
                       4 * b * heads * hd * l * l, dtname)
    rec = {
        "check": name, "kernel": "attention_qkv_rows", "shape": [b, l, 3 * d],
        "heads": heads, "nb": nb, "dtype": dtname,
        "route": att.attention_route(l, hd, dtype),
        "blocks": -(-l // 64) * heads * (b // nb),
        "blocks_per_sm": att.blocks_per_sm(l, hd, dtype, rows=True),
        "smem_bytes_per_block": att.rows_smem_bytes(l, hd, dtype),
        "max_abs_err": err, "atol": atol, "rtol": rtol, "tolerance": why,
        "bitwise_repeatable": repeatable,
        "equal_to_k1": equal_k1,
        "refuses_b_mod_nb": refused,
        "ms": time_ms(lambda: att.attention_qkv_rows(qkv, heads, nb), 20),
        "k1_ms": time_ms(lambda: att.fused_attention_qkv(qkv, heads, False),
                         20),
        "plain_ms": time_ms(
            lambda: att.attention_qkv_rows_plain(qkv, heads, nb), 5),
        "library_ms": time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v), 20),
        "bound_ms": b_ms, "bound_by": b_by,
        "pass": ok and repeatable and refused and equal_k1,
    }
    emit(rec)
    if not rec["pass"]:
        raise AssertionError(f"{name}: max abs err {err}, repeatable "
                             f"{repeatable}, B % nb refused {refused}, "
                             f"equal to K1 {equal_k1}")
    return rec


def check_temporal_net(name, shape, dtype, seed):
    import torch
    from dist_tpu_torch.ops import temporal_net as tn

    b, t, h, w, c = shape
    f, k = c, 3
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen, device="cuda") * scale

    x = rnd(*shape).to(dtype)
    params = (1.0 + rnd(c, scale=0.1), rnd(c, scale=0.1),
              rnd(k, 1, 1, c, f, scale=(k * c) ** -0.5), rnd(f, scale=0.1),
              rnd(1, 3, 3, f, c, scale=(9 * f) ** -0.5), rnd(c, scale=0.1))
    got = tn.fused_temporal_net(x, *params)
    want = tn.temporal_net_plain(x, *params)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        # fp32 inside both; sums of 288 and 864 terms in another order
        atol, rtol, why = 1e-4, 1e-5, "fp32 summation order"
    else:
        # fp32 inside both; the output's rounding to bf16 may fall one
        # step (<= 2^-7 relative) apart
        atol, rtol, why = 1e-4, 2 ** -7, "bf16 rounding of the output"
    err, ok = compare(got, want, atol, rtol)
    dtname = str(dtype).split(".")[-1]
    n = b * t * h * w
    param_bytes = 4 * (k * c * f + 9 * f * c + 3 * c + f)
    # the block's arithmetic is fp32 whatever x's type: fp32 peak
    b_ms, b_by = bound(2 * x.numel() * x.element_size() + param_bytes,
                       2 * n * c * f * (k + 9), "float32")
    rec = {
        "check": name, "kernel": "temporal_net_fwd", "shape": list(shape),
        "k": k, "dtype": dtname, "max_abs_err": err, "atol": atol,
        "rtol": rtol, "tolerance": why,
        "ms": time_ms(lambda: tn.fused_temporal_net(x, *params), 20),
        "plain_ms": time_ms(lambda: tn.temporal_net_plain(x, *params), 5),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by, "pass": ok,
    }
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max abs err {err})")
    return rec


def check_temporal_net_bwd(name, shape, dtype, seed):
    """K3 against its plain version on seeded inputs and cotangent, on the
    route x's dtype takes: fp32, every output within atol + rtol |ref|;
    bf16, every output within ``BWD_BF16_LIMITS`` and the control (the
    plain version with w2's (0, 0) tap zeroed) outside them. And two
    launches bit for bit."""
    import torch
    from dist_tpu_torch.ops import temporal_net as tn
    from dist_tpu_torch.tools import tnet_bwd

    b, t, h, w, c = shape
    f, k = c, 3
    x, g, params = tnet_bwd.inputs(shape, f, k, seed, dtype)
    route = tn.temporal_net_bwd_route(dtype)
    got = tn.fused_temporal_net_bwd(x, g, *params)
    again = tn.fused_temporal_net_bwd(x, g, *params)
    want = tn.temporal_net_bwd_plain(x, g, *params)
    torch.cuda.synchronize()
    outputs, extra = {}, {}
    for nm, gi, wi in zip(tnet_bwd.NAMES, got, want):
        scale = float(wi.float().abs().max())
        # fp32 sums in another order: the weight grads over N positions
        # in 32 chunks here, in cuBLAS's blocking in the plain version
        atol, rtol = 1e-5 * scale + 1e-6, 1e-5
        err, good = compare(gi, wi, atol, rtol)
        outputs[nm] = {"max_abs_err": err, "max_abs_ref": scale}
        if route == "fp32":
            outputs[nm].update(atol=atol, rtol=rtol,
                               tolerance="fp32 summation order", ok=good)
    if route == "bf16_mma":
        readings = tnet_bwd.errors(got, want)
        control = tnet_bwd.errors(got, tn.temporal_net_bwd_plain(
            x, g, *tnet_bwd.control_params(params)))
        for nm in tnet_bwd.NAMES:
            lims = {nm: BWD_BF16_LIMITS[nm]}
            outputs[nm].update(readings[nm], limits=BWD_BF16_LIMITS[nm],
                               tolerance="bf16 product operands",
                               ok=not tnet_bwd.breaches(readings, lims))
        extra = {"control": control,
                 "control_breaches": tnet_bwd.breaches(control,
                                                       BWD_BF16_LIMITS),
                 "occupancy": tn.bwd_occupancy(c, f)}
    ok = all(o["ok"] for o in outputs.values()) and (
        route == "fp32" or bool(extra["control_breaches"]))
    repeatable = all(bool(torch.equal(a1, a2)) for a1, a2 in zip(got, again))
    n = b * t * h * w
    param_bytes = 4 * (k * c * f + 9 * f * c + 3 * c + f)
    # reads x and the cotangent, the parameters; writes dx and the 7 grads'
    # fp32 weights; the operations: the forward again and two gradient
    # products per tap, 6 N C F (k + 9), on the tensor cores in bf16 and on
    # the CUDA cores in fp32
    b_ms, b_by = bound(3 * x.numel() * x.element_size() + 2 * param_bytes,
                       6 * n * c * f * (k + 9),
                       "bfloat16" if route == "bf16_mma" else "float32")
    dtname = str(dtype).split(".")[-1]
    rec = {
        "check": name, "kernel": "temporal_net_bwd", "shape": list(shape),
        "k": k, "dtype": dtname, "route": route,
        "max_abs_err": max(o["max_abs_err"] for o in outputs.values()),
        "outputs": outputs, **extra, "bitwise_repeatable": repeatable,
        "ms": time_ms(lambda: tn.fused_temporal_net_bwd(x, g, *params), 10),
        "plain_ms": time_ms(
            lambda: tn.temporal_net_bwd_plain(x, g, *params), 3),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "pass": ok and repeatable,
    }
    emit(rec)
    if not rec["pass"]:
        raise AssertionError(f"{name}: kernel and plain version disagree, "
                             f"the control passes or two launches differ "
                             f"({outputs}, {extra.get('control_breaches')}, "
                             f"repeatable {repeatable})")
    return rec


def kernel_checks():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    att = [
        check_attention("attention vision fp32", 64, 197, 12, 64, False, f32, 1),
        check_attention("attention vision bf16", 64, 197, 12, 64, False, bf16, 2),
        check_attention("attention text causal bf16", 174, 77, 8, 64, True,
                        bf16, 3),
        check_attention("attention L/14 bf16", 16, 257, 16, 64, False, bf16, 4),
        # past the whole-row lengths: ViT-L/14 at 336 px, 24^2 + 1 tokens
        check_attention("attention L/14-336 bf16", 8, 577, 16, 64, False,
                        bf16, 20),
    ]
    tnet = [
        check_temporal_net("temporal_net fp32", (8, 16, 14, 14, 96), f32, 5),
        check_temporal_net("temporal_net bf16", (8, 16, 14, 14, 96), bf16, 6),
    ]
    # the shapes of the train step: batch 32, 8 sparse frames in the vision
    # tower, 16 dense frames in the ladder
    train = {
        "attention_qkv": check_attention("attention vision train bf16", 256,
                                         197, 12, 64, False, bf16, 7,
                                         streaming=True),
        "temporal_net_fwd": check_temporal_net(
            "temporal_net train bf16", (32, 16, 14, 14, 96), bf16, 8),
    }
    bwd32 = check_temporal_net_bwd("temporal_net_bwd train fp32",
                                   (32, 16, 14, 14, 96), f32, 9)
    train["temporal_net_bwd"] = check_temporal_net_bwd(
        "temporal_net_bwd train bf16", (32, 16, 14, 14, 96), bf16, 10)
    train["temporal_net_bwd"]["fp32_route"] = bwd32
    # K4 at the microbenchmark's shape, each nb of its attn command
    rows = {nb: check_attention_rows(f"attention_rows nb={nb} bf16", 64, 197,
                                     12, 64, nb, bf16, 10 + nb)
            for nb in K4_ROWS}
    check_attention_rows("attention_rows nb=8 fp32", 64, 197, 12, 64, 8,
                         f32, 19)
    check_route_sweep()
    # the shapes and type of the served model's main path, the train
    # step's, and the tools'; K1's streaming route at L > 272 beside them
    train["attention_qkv"]["streaming_route"] = att[4]
    return ({"attention_qkv": att[1], "temporal_net_fwd": tnet[1]}, train,
            rows)


def serve(repo):
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.ops.attention import fused_attention_qkv
    from dist_tpu_torch.ops.temporal_net import fused_temporal_net
    from dist_tpu_torch.serving.engine import InferenceEngine

    cfg = load_config(os.path.join(repo, FLAGSHIP),
                      ["TPU.FUSED_TEMPORAL_NET", "true"],
                      make_output_dir=False)
    rng = np.random.default_rng(int(cfg.RANDOM_SEED))
    shape = (int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TEST_CROP_SIZE),
             int(cfg.DATA.TEST_CROP_SIZE), 3)
    requests = [rng.integers(0, 256, (n,) + shape, dtype=np.uint8)
                for n in SERVE_REQUESTS]

    fused_attention_qkv.launches = 0
    fused_temporal_net.launches = 0
    # the kernel checks at the train shapes ran before; count from here
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, batch_size=8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    setup_k1 = fused_attention_qkv.launches
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    latencies, results = [], []
    for clips in requests:
        t0 = time.perf_counter()
        scores = engine.predict(clips)
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append(scores)
    launches = {"attention_qkv": fused_attention_qkv.launches,
                "temporal_net_fwd": fused_temporal_net.launches}

    arch = engine.model.module.arch
    ladder = len(engine.model.module.dist.selected_layers)
    batches = len(engine.buckets()) + len(requests)
    want = {"attention_qkv": (arch.transformer_layers
                              + arch.vision_layers * batches),
            "temporal_net_fwd": ladder * batches}
    problems = []
    if setup_k1 != arch.transformer_layers:
        problems.append(f"text setup launched the attention kernel "
                        f"{setup_k1} times")
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    for clips, scores in zip(requests, results):
        n = clips.shape[0]
        if scores.shape != (n, engine.num_classes):
            problems.append(f"scores shape {scores.shape}")
        elif not np.isfinite(scores).all():
            problems.append("non-finite scores")
        elif not np.allclose(scores.sum(axis=1), 1.0, atol=1e-4):
            problems.append(f"rows sum to {scores.sum(axis=1)}")

    steady = []
    for _ in range(TIMED_REPEATS):
        t0 = time.perf_counter()
        engine.predict(requests[-1])
        steady.append((time.perf_counter() - t0) * 1e3)
    steady.sort()
    rec = {
        "phase": "serving", "config": FLAGSHIP,
        "overrides": ["TPU.FUSED_TEMPORAL_NET", "true"],
        "classes": engine.num_classes, "batch_size": engine.batch_size,
        "buckets": engine.buckets(), "dtype": str(engine.model.module.dtype),
        "build_s": build_s, "warmup_s": warmup_s,
        "request_clips": list(SERVE_REQUESTS), "request_ms": latencies,
        "batch8_ms_median": steady[len(steady) // 2],
        "batch8_ms_min": steady[0],
        "clips_per_s": 8e3 / steady[len(steady) // 2],
        "launches": launches, "expected_launches": want,
        "text_setup_attention_launches": setup_k1,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "pass": not problems,
    }
    emit(rec)
    if problems:
        raise AssertionError("serving: " + "; ".join(problems))
    return engine, launches


def _cosine(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))


def _run(model, clips, text_features):
    """-> (scores, logits, video embeddings) of one request, as numpy."""
    import torch
    from dist_tpu_torch.tasks.state import _prep_video

    video = _prep_video(model.cfg, torch.from_numpy(clips).to(model.device))
    with torch.no_grad():
        preds, out = model.apply({"video": video,
                                  "text_features": text_features})
    return tuple(t.float().cpu().numpy() for t in (
        preds, out["logits_per_image"][:, 0], out["vid_logits"][:, 0]))


def _diff(ref, other):
    import numpy as np

    return {"max_abs_score_diff": float(np.abs(other[0] - ref[0]).max()),
            "max_abs_logit_diff": float(np.abs(other[1] - ref[1]).max()),
            "min_embedding_cosine": min(_cosine(a, b)
                                        for a, b in zip(other[2], ref[2]))}


def _drop_spatial_tap(model, blocks):
    """Control: zero the (0, 0) tap of the 3x3 spatial conv in the first
    ``blocks`` TemporalNets, as a kernel that skipped one of its nine taps
    would."""
    import torch

    with torch.no_grad():
        for net in list(model.module.dist_net.temporal_nets)[:blocks]:
            net.temporal_net["c_fc2"].weight[:, :, :, 0, 0] = 0


def _agree_one_seed(repo, engine, tokens, seed):
    """Readings of one weight seed: the served model against the unfused
    TemporalNet on the card, the plain versions on the CPU (both bf16, as
    served) and the card against the CPU with both in fp32; and the
    controls, the unfused model with one K2 spatial tap dropped."""
    import numpy as np
    import torch
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features

    def cfg_with(*opts):
        return load_config(os.path.join(repo, FLAGSHIP), list(opts),
                           make_output_dir=False)

    rng = np.random.default_rng(seed)
    clips = rng.integers(0, 256, (AGREEMENT_CLIPS, engine.num_frames,
                                  engine.crop, engine.crop, 3), dtype=np.uint8)
    if seed == int(engine.cfg.RANDOM_SEED):
        card, text = engine.model, engine.text_features
    else:
        card = build_model(engine.cfg, seed=seed)
        text = compute_text_features(card, tokens)
    rec = {"seed": seed}
    served = _run(card, clips, text)

    # the label-text path is the same code in both card models
    unfused = build_model(cfg_with("TPU.FUSED_TEMPORAL_NET", "false"),
                          seed=seed)
    rec["unfused_card"] = _diff(served, _run(unfused, clips, text))
    for name, blocks in CONTROLS.items():
        _drop_spatial_tap(unfused, blocks)
        rec[name] = _diff(served, _run(unfused, clips, text))
    del unfused

    # the CPU gets the card's label-text features; 8 prompts of them are
    # recomputed on the CPU and compared
    cpu = build_model(engine.cfg, device="cpu", seed=seed)
    rec["cpu"] = _diff(served, _run(cpu, clips, text.cpu()))
    t_cpu = compute_text_features(cpu, tokens[:8]).float().numpy()
    t_card = text[:8].float().cpu().numpy()
    rec["cpu"]["min_text_cosine"] = min(_cosine(a, b)
                                        for a, b in zip(t_cpu, t_card))
    del cpu, card

    # fp32 on both sides (TF32 off)
    cfg32 = cfg_with("TPU.FUSED_TEMPORAL_NET", "true",
                     "TRAIN.MIXED_PRECISION", "false")
    card32 = build_model(cfg32, seed=seed)
    text32 = compute_text_features(card32, tokens)
    ref32 = _run(card32, clips, text32)
    del card32
    torch.cuda.empty_cache()
    rec["fp32_card_vs_cpu"] = _diff(ref32, _run(
        build_model(cfg32, device="cpu", seed=seed), clips, text32.cpu()))
    return rec


def agreement(repo, engine):
    """The served model's scores, logits and embeddings for one request of
    each weight seed in ``AGREEMENT_SEEDS``, held to the limits of
    ``AGREEMENT_LIMITS``; ``CONTROL_MUST_BREAK`` must break at least one
    limit of each bf16 comparison, or the limits could not see a skipped
    tap."""
    from dist_tpu_torch.data.base_dataset import resolve_label_texts

    _, tokens = resolve_label_texts(engine.cfg, engine.num_classes)
    base = int(engine.cfg.RANDOM_SEED)
    runs = [_agree_one_seed(repo, engine, tokens, base + i)
            for i in range(AGREEMENT_SEEDS)]
    problems = []
    for run in runs:
        for key, limits in AGREEMENT_LIMITS.items():
            for metric, worst in _breaches(run[key], limits):
                problems.append(f"seed {run['seed']} {key}: {metric} {worst}")
        for key in ("unfused_card", "cpu"):
            if not _breaches(run[CONTROL_MUST_BREAK], AGREEMENT_LIMITS[key]):
                problems.append(f"seed {run['seed']} control "
                                f"{CONTROL_MUST_BREAK} passes the {key} limits")
    emit({"phase": "agreement", "clips": AGREEMENT_CLIPS, "runs": runs,
          "limits": AGREEMENT_LIMITS, "pass": not problems})
    if problems:
        raise AssertionError("agreement: " + "; ".join(problems))


def _train_cfg(repo, *opts):
    from dist_tpu_torch.config import load_config

    return load_config(os.path.join(repo, FLAGSHIP),
                       ["TPU.FUSED_TEMPORAL_NET", "true", *opts],
                       make_output_dir=False)


def _train_batches(cfg, n, seed, clips=None):
    """``n`` seeded batches of uint8 clips (B, 16, 224, 224, 3) and labels,
    made on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = int(clips or cfg.TRAIN.BATCH_SIZE)
    t, crop = int(cfg.DATA.NUM_INPUT_FRAMES), int(cfg.DATA.TRAIN_CROP_SIZE)
    classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    return [{"video": torch.randint(0, 256, (b, t, crop, crop, 3),
                                    generator=gen, device="cuda",
                                    dtype=torch.int32).to(torch.uint8),
             "labels": torch.randint(0, classes, (b,), generator=gen,
                                     device="cuda")} for _ in range(n)]


def _zero_counts():
    from dist_tpu_torch.ops.attention import (
        attention_qkv_rows,
        fused_attention_qkv,
    )
    from dist_tpu_torch.ops.temporal_net import (
        fused_temporal_net,
        fused_temporal_net_bwd,
    )

    fns = {"attention_qkv": fused_attention_qkv,
           "attention_qkv_rows": attention_qkv_rows,
           "temporal_net_fwd": fused_temporal_net,
           "temporal_net_bwd": fused_temporal_net_bwd}
    for fn in fns.values():
        fn.launches = 0
    return lambda: {name: fn.launches for name, fn in fns.items()}


def train(repo):
    """The flagship's train step at full width: set-up (weights from
    RANDOM_SEED, label-text features once), then warm-up and timed steps
    with mixup/cutmix and label smoothing as configured."""
    import torch
    from dist_tpu_torch.data.base_dataset import resolve_label_texts
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        compute_text_features,
        create_train_state,
        ema_decay,
        make_train_step,
    )

    cfg = _train_cfg(repo)
    classes = int(cfg.VIDEO.HEAD.NUM_CLASSES)
    t0 = time.perf_counter()
    model = build_model(cfg)
    _, tokens = resolve_label_texts(cfg, classes)
    counts = _zero_counts()
    text = compute_text_features(model, tokens)
    torch.cuda.synchronize()
    setup = counts()
    optimizer, lr_fn = construct_optimizer(cfg, model.module,
                                           TRAIN_STEPS_PER_EPOCH)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    step = make_train_step(model, cfg, optimizer, lr_fn)
    build_s = time.perf_counter() - t0
    params = dict(model.module.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    steps = TRAIN_WARMUP_STEPS + TRAIN_TIMED_STEPS
    batches = _train_batches(cfg, steps, int(cfg.RANDOM_SEED))
    gen = torch.Generator().manual_seed(int(cfg.RANDOM_SEED))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts = _zero_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        metrics = step(state, {**batch, "text_features": text}, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    arch = model.module.arch
    ladder = len(model.module.dist.selected_layers)
    want = {"attention_qkv": arch.vision_layers * steps,
            "attention_qkv_rows": 0,
            "temporal_net_fwd": ladder * steps,
            "temporal_net_bwd": ladder * steps}
    losses = [float(v) for v in losses]
    problems = []
    if setup != {"attention_qkv": arch.transformer_layers,
                 "attention_qkv_rows": 0, "temporal_net_fwd": 0,
                 "temporal_net_bwd": 0}:
        problems.append(f"set-up launches {setup}")
    if launches != want:
        problems.append(f"launches {launches} != expected {want}")
    if not all(math.isfinite(v) for v in losses):
        problems.append(f"losses {losses}")
    unmoved, zero_grad = [], []
    for k, p in params.items():
        if not p.requires_grad:
            if not torch.equal(p, before[k]):
                problems.append(f"frozen {k} changed")
        elif not bool(p.grad.abs().max() > 0):
            zero_grad.append(k)
        elif torch.equal(p, before[k]):
            unmoved.append(k)
    if unmoved:
        problems.append(f"trainable parameters that did not move: {unmoved}")
    if not any(k.startswith("dist_net.") for k, p in params.items()
               if p.requires_grad) or any(
            p.requires_grad for k, p in params.items()
            if not k.startswith("dist_net.")):
        problems.append("the trainable parameters are not dist_net's")
    # the same step with the unfused TemporalNet (cuDNN convs and autograd),
    # timed beside it on the same card after the checks above
    _set_fused(model, False)
    unfused = []
    for batch in batches[:TRAIN_WARMUP_STEPS + 3]:
        t0 = time.perf_counter()
        step(state, {**batch, "text_features": text}, gen)
        torch.cuda.synchronize()
        unfused.append((time.perf_counter() - t0) * 1e3)
    unfused = sorted(unfused[TRAIN_WARMUP_STEPS:])
    timed = sorted(times[TRAIN_WARMUP_STEPS:])
    b = int(cfg.TRAIN.BATCH_SIZE)
    rec = {
        "phase": "train", "config": FLAGSHIP,
        "overrides": ["TPU.FUSED_TEMPORAL_NET", "true"], "batch_size": b,
        "dtype": str(model.module.dtype), "classes": classes,
        "optimizer": cfg.OPTIMIZER.OPTIM_METHOD,
        "param_groups": {g["group"]: len(g["params"])
                         for g in optimizer.param_groups},
        "trainable_params": sum(p.numel() for p in params.values()
                                if p.requires_grad),
        "frozen_params": sum(p.numel() for p in params.values()
                             if not p.requires_grad),
        "build_s": build_s, "step_ms": times, "losses": losses,
        "lr_last": lr_fn(steps - 1),
        "step_ms_median": timed[len(timed) // 2], "step_ms_min": timed[0],
        "clips_per_s": b * 1e3 / timed[len(timed) // 2],
        "unfused_step_ms": unfused,
        "unfused_step_ms_median": unfused[len(unfused) // 2],
        "peak_mem_gb": peak, "launches": launches,
        "expected_launches": want, "setup_launches": setup,
        "zero_grad_params": zero_grad, "pass": not problems,
    }
    emit(rec)
    if problems:
        raise AssertionError("train: " + "; ".join(problems))
    return launches, tokens


def _step_grads(model, cfg, batch, text):
    """One train step's loss and trainable gradients (fp64 on the CPU),
    with the LR at 0 so that the weights stay as they are."""
    import torch
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import create_train_state, make_train_step

    optimizer, _ = construct_optimizer(cfg, model.module,
                                       TRAIN_STEPS_PER_EPOCH)
    step = make_train_step(model, cfg, optimizer, lambda _: 0.0)
    metrics = step(create_train_state(model, optimizer),
                   {**batch, "text_features": text}, None)
    grads = {k: p.grad.detach().double().cpu()
             for k, p in model.module.named_parameters() if p.requires_grad}
    return float(metrics["loss"]), grads


def _grad_diff(ref, other):
    """Loss and per-tensor gradient agreement of ``other`` with ``ref``;
    tensors whose gradient is zero on both sides are counted apart."""
    (loss_r, g_r), (loss_o, g_o) = ref, other
    rel, cos, zero = {}, {}, []
    for k, b in g_r.items():
        a = g_o[k]
        na, nb = float(a.norm()), float(b.norm())
        if na == 0.0 and nb == 0.0:
            zero.append(k)
            continue
        rel[k] = float((a - b).norm()) / max(nb, 1e-300)
        cos[k] = float((a * b).sum()) / max(na * nb, 1e-300)
    worst_rel = max(rel, key=rel.get)
    worst_cos = min(cos, key=cos.get)
    return {"max_grad_rel_err": rel[worst_rel], "worst_rel_param": worst_rel,
            "min_grad_cosine": cos[worst_cos], "worst_cos_param": worst_cos,
            "loss_rel_diff": abs(loss_o - loss_r) / abs(loss_r),
            "tensors": len(rel), "zero_grad_tensors": len(zero),
            # the per-tensor readings of the five worst tensors
            "worst_tensors": [[k, rel[k], cos[k]] for k in sorted(
                rel, key=rel.get, reverse=True)[:5]]}


def _set_fused(model, fused):
    for net in model.module.dist_net.temporal_nets:
        net.fused = fused


def _train_agree_one_seed(repo, tokens, seed):
    import torch
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.tasks.state import compute_text_features

    nomix = ("AUGMENTATION.MIXUP.ENABLE", "false",
             "AUGMENTATION.CUTMIX.ENABLE", "false")
    cfg16 = _train_cfg(repo, *nomix)
    cfg32 = _train_cfg(repo, *nomix, "TRAIN.MIXED_PRECISION", "false")
    batch = _train_batches(cfg16, 1, seed)[0]
    small = {k: v[:TRAIN_AGREEMENT_CPU_CLIPS] for k, v in batch.items()}
    model = build_model(cfg16, seed=seed)
    text = compute_text_features(model, tokens)
    rec = {"seed": seed}

    fused16 = _step_grads(model, cfg16, batch, text)
    _set_fused(model, False)
    rec["unfused_card_bf16"] = _grad_diff(
        fused16, _step_grads(model, cfg16, batch, text))
    # the control, in bf16 at batch 32 and in fp32 at batch 2 (the weights
    # are fp32 either way; the activations follow the module's dtype)
    saved = [net.temporal_net["c_fc2"].weight.detach().clone()
             for net in model.module.dist_net.temporal_nets]
    _drop_spatial_tap(model, TRAIN_CONTROL_BLOCKS)
    ctrl16 = _step_grads(model, cfg16, batch, text)
    model.module.dtype = torch.float32
    ctrl32 = _step_grads(model, cfg32, small, text)
    with torch.no_grad():
        for net, w in zip(model.module.dist_net.temporal_nets, saved):
            net.temporal_net["c_fc2"].weight.copy_(w)
    _set_fused(model, True)
    card32 = _step_grads(model, cfg32, small, text)
    rec["control_bf16"] = _grad_diff(fused16, ctrl16)
    rec["control_fp32"] = _grad_diff(card32, ctrl32)
    del model
    torch.cuda.empty_cache()

    cpu = build_model(cfg32, device="cpu", seed=seed)
    rec["cpu_fp32"] = _grad_diff(card32, _step_grads(
        cpu, cfg32, {k: v.cpu() for k, v in small.items()}, text.cpu()))
    return rec


def train_agreement(repo, tokens):
    """One step's dist_net gradients and loss, mixup off, for three weight
    seeds: the fused path against the unfused one (bf16 on the card, batch
    32) and the card against the CPU (fp32, batch 2), held to
    ``TRAIN_AGREEMENT_LIMITS``; the control must break both."""
    import torch

    base = int(_train_cfg(repo).RANDOM_SEED)
    runs = [_train_agree_one_seed(repo, tokens, base + i)
            for i in range(AGREEMENT_SEEDS)]
    problems = []
    for run in runs:
        for key, limits in TRAIN_AGREEMENT_LIMITS.items():
            for metric, worst in _breaches(run[key], limits):
                problems.append(f"seed {run['seed']} {key}: {metric} {worst}")
        for key, ctrl in (("unfused_card_bf16", "control_bf16"),
                          ("cpu_fp32", "control_fp32")):
            if not _breaches(run[ctrl], TRAIN_AGREEMENT_LIMITS[key]):
                problems.append(f"seed {run['seed']} {ctrl} passes the "
                                f"{key} limits")
    torch.cuda.empty_cache()
    emit({"phase": "train_agreement", "runs": runs,
          "cpu_clips": TRAIN_AGREEMENT_CPU_CLIPS,
          "limits": TRAIN_AGREEMENT_LIMITS, "pass": not problems})
    if problems:
        raise AssertionError("train_agreement: " + "; ".join(problems))


def _http(port, path, body=None):
    """(status, JSON reply) of one request to the local server."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST" if body is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def http_round_trip(repo):
    """The flagship served over HTTP at batch 8: HTTP_CLIPS clips POSTed
    from as many threads, health and stats, every top-k score against the
    engine's own predict of the clip, and a bad payload."""
    import io
    import threading

    import numpy as np
    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.server import VideoClassifierServer

    cfg = load_config(os.path.join(repo, FLAGSHIP),
                      ["TPU.FUSED_TEMPORAL_NET", "true"],
                      make_output_dir=False)
    t0 = time.perf_counter()
    server = VideoClassifierServer(cfg, host="127.0.0.1", port=0,
                                   batch_size=8, max_delay_ms=20.0)
    build_s = time.perf_counter() - t0
    engine = server.engine
    rng = np.random.default_rng(int(cfg.RANDOM_SEED) + 7)
    clips = rng.integers(0, 256, (HTTP_CLIPS, engine.num_frames, engine.crop,
                                  engine.crop, 3), dtype=np.uint8)
    replies = [None] * HTTP_CLIPS

    def post(i):
        buf = io.BytesIO()
        np.save(buf, clips[i])
        replies[i] = _http(server.port, "/v1/predict?topk=5", buf.getvalue())

    with server:
        health = _http(server.port, "/v1/health")
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(HTTP_CLIPS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        stats = _http(server.port, "/v1/stats")
        bad = io.BytesIO()
        np.save(bad, np.zeros((2, 2), np.uint8))
        bad_status, _ = _http(server.port, "/v1/predict", bad.getvalue())
        direct = [engine.predict(c[None])[0] for c in clips]
    problems, worst = [], 0.0
    if health != (200, {"status": "ok", "classes": engine.num_classes,
                        "frames": engine.num_frames, "crop": engine.crop,
                        "batch_size": 8}):
        problems.append(f"health {health}")
    for i, reply in enumerate(replies):
        if reply is None or reply[0] != 200 or len(reply[1]["topk"]) != 5:
            problems.append(f"clip {i}: reply {reply}")
            continue
        for row in reply[1]["topk"]:
            worst = max(worst, abs(row["score"] - float(direct[i][row["class"]])))
    if worst > HTTP_SCORE_LIMIT:
        problems.append(f"top-k score off the engine's predict by {worst}")
    if stats[0] != 200 or stats[1]["requests"] != HTTP_CLIPS:
        problems.append(f"stats {stats}")
    if bad_status != 400:
        problems.append(f"bad payload answered {bad_status}")
    return {"build_s": build_s, "health": health[1], "stats": stats[1],
            "max_abs_score_diff": worst, "limit": HTTP_SCORE_LIMIT,
            "bad_payload_status": bad_status}, problems


def _run_tool(repo, args, env=None):
    """Run ``python -m dist_tpu_torch.tools.<args>`` from the checkout:
    (seconds, every stdout line parsed as JSON); raises on a non-zero exit
    or a line that does not parse."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], cwd=repo,
                         env={**os.environ, **(env or {})},
                         capture_output=True, text=True,
                         timeout=TOOL_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(args)} exited {out.returncode}: "
                             f"{out.stderr[-3000:]}")
    return seconds, [json.loads(ln) for ln in out.stdout.splitlines()
                     if ln.strip()]


def tools(repo):
    """The port's tools at full width. In this process, with the launch
    counts zeroed just before and read just after: ``microbench attn`` and
    the HTTP round trip. Then the other tools as subprocesses."""
    import contextlib
    import io

    import torch
    from dist_tpu_torch.tools import microbench

    t0 = time.perf_counter()
    counts = _zero_counts()
    bench = microbench.Bench(torch.device("cuda"), reps=TOOLS_REPS)
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        microbench.cmd_attn(bench, [])
    attn = [json.loads(ln) for ln in captured.getvalue().splitlines()]
    http, problems = http_round_trip(repo)
    launches = counts()

    names = {r["variant"] for r in attn}
    expected = {"attn_shipped", "attn_plain", "attn_sdpa",
                *(f"attn_rows{nb}" for nb in K4_ROWS)}
    if names != expected:
        problems.append(f"microbench attn variants {sorted(names)}")
    for r in attn:
        if "error" in r or "ms" not in r:
            problems.append(f"microbench attn: {r}")
        elif r["variant"].startswith("attn_rows") and (
                r["max_abs_diff"] > 2 ** -8 * r["max_abs_ref"]):
            # within the bf16 tolerance of K1 (2^-8 max|V| + 2^-7 |O|)
            # everywhere: max|O| <= max|V|, since O is a convex sum of V
            problems.append(f"K4 off K1: {r}")
    for name in ("attention_qkv", "attention_qkv_rows", "temporal_net_fwd"):
        if launches[name] == 0:
            problems.append(f"{name} not launched in the tools phase")

    runs = {}
    runs["microbench conv33"] = _run_tool(
        repo, ["dist_tpu_torch.tools.microbench", "conv33"],
        {"REPS": str(TOOLS_REPS)})
    runs["bench"] = _run_tool(
        repo, ["dist_tpu_torch.tools.bench"],
        {"BENCH_ITERS": "5", "BENCH_OPTS": "TPU.FUSED_TEMPORAL_NET true"})
    runs["bench_serving"] = _run_tool(
        repo, ["dist_tpu_torch.tools.bench_serving", "--iters", "10",
               "--load-seconds", "2", "TPU.FUSED_TEMPORAL_NET", "true"])
    runs["profile_eval"] = _run_tool(
        repo, ["dist_tpu_torch.tools.profile_eval", "full_eval",
               "attn_kernel"], {"BENCH_ITERS": "10"})
    for name, (_, lines) in runs.items():
        if any("error" in r for r in lines):
            problems.append(f"{name}: {lines}")
    conv33 = runs["microbench conv33"][1]
    if [r.get("check") or r.get("variant") for r in conv33] != [
            "max_abs_diff", "conv33_fwd_bwd", "mm33_fwd_bwd"]:
        problems.append(f"microbench conv33: {conv33}")
    metrics = {r.get("metric"): r.get("value") for r in runs["bench"][1]}
    if set(metrics) != {"clips_per_sec_per_chip",
                        "train_clips_per_sec_per_chip"} or not all(
            v > 0 for v in metrics.values()):
        problems.append(f"bench: {runs['bench'][1]}")
    serving = runs["bench_serving"][1]
    if len(serving) != 1 or not serving[0]["sustained_load"][
            "clips_per_sec"] > 0:
        problems.append(f"bench_serving: {serving}")
    components = [r.get("component") for r in runs["profile_eval"][1]]
    if components != ["full_eval", "attn_kernel_x1"]:
        problems.append(f"profile_eval components {components}")

    rec = {"phase": "tools", "microbench_attn": attn, "http": http,
           "launches": launches,
           "runs": {name: {"seconds": sec, "lines": lines}
                    for name, (sec, lines) in runs.items()},
           "seconds": time.perf_counter() - t0, "pass": not problems}
    emit(rec)
    if problems:
        raise AssertionError("tools: " + "; ".join(problems))
    return launches


def _instance(mangled):
    """``attention_qkv_wr_kernel<64, 208, false>`` for a mangled whole-row
    kernel name."""
    import re

    m = re.search(r"(attention_(?:qkv|rows)_wr_kernel)ILi(\d+)ELi(\d+)E(?:Lb([01])E)?",
                  mangled)
    if not m:
        return mangled
    args = [m[2], m[3]] + ([("false", "true")[int(m[4])]] if m[4] else [])
    return f"{m[1]}<{', '.join(args)}>"


def _attention_entry(rec, kernel):
    """An attention check's route, blocks per SM and the ptxas usage of
    the whole-row instance of ``kernel`` that its shape launches."""
    from dist_tpu_torch.ops import _build
    from dist_tpu_torch.ops.attention import WHOLE_ROW_LENS

    out = {"attention_route": rec["route"],
           "blocks_per_sm": rec["blocks_per_sm"], "ptxas": None}
    if rec["route"] == "whole_row":
        _, l, d3 = rec["shape"]
        lp = next(p for p in WHOLE_ROW_LENS if l <= p)
        mask = ""                # K1's instances differ in the causal mask
        if "causal" in rec:
            mask = ", true" if rec["causal"] else ", false"
        name = f"{kernel}<{d3 // 3 // rec['heads']}, {lp}{mask}>"
        usage = {_instance(k): v
                 for k, v in _build.ptxas_usage("attention").items()}
        if name not in usage:
            raise AssertionError(f"no ptxas usage of {name}")
        out["ptxas"] = {"instance": name,
                        "registers": usage[name]["registers"],
                        "spill_bytes": usage[name]["spill_stores"]
                        + usage[name]["spill_loads"]}
    return out


def _k3_usage():
    """{instance: ptxas usage} of every kernel of K3's bf16 route."""
    from dist_tpu_torch.ops import _build
    from dist_tpu_torch.tools.tnet_bwd import instance_name

    return {instance_name(k): v
            for k, v in _build.ptxas_usage("temporal_net").items()
            if "k3_" in k}


def _bwd_entry(rec):
    """K3's route, the blocks per SM and shared bytes per block of its
    main stage (B, the 3x3 taps), each kernel's occupancy, and the ptxas
    registers and spill bytes of the instances its shape launches."""
    from dist_tpu_torch.ops.temporal_net import _padded

    occ = rec["occupancy"]
    p = _padded(rec["shape"][-1], rec["shape"][-1])
    return {"bwd_route": rec["route"],
            "blocks_per_sm": occ["stage_B"]["blocks_per_sm"],
            "smem_bytes_per_block": occ["stage_B"]["smem_bytes"],
            "occupancy": occ,
            "ptxas": {k: {"registers": v.get("registers"),
                          "spill_bytes": v.get("spill_stores", 0)
                          + v.get("spill_loads", 0)}
                      for k, v in sorted(_k3_usage().items())
                      if f"<{p}" in k or "<" not in k}}


def _breaches(reading, limits):
    """[(metric, reading)] of the limits a comparison's reading breaks;
    a ``min_`` limit is a floor, the others are ceilings. A control has no
    text reading (it shares the served text features)."""
    out = []
    for metric, limit in limits.items():
        if metric not in reading:
            continue
        v = reading[metric]
        if (v < limit) if metric.startswith("min_") else (v > limit):
            out.append((metric, v))
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU",
              file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "dist_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(dist_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    os.chdir(repo)
    try:
        card = card_line()
        emit({"phase": "card", "nvidia_smi": card,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(), "torch": torch.__version__,
              "cuda": torch.version.cuda})
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        from dist_tpu_torch.ops import _build
        names = ["attention", "temporal_net"]
        t0 = time.perf_counter()
        _build.build(names)
        whole_row = {_instance(k): v
                     for k, v in _build.ptxas_usage("attention").items()
                     if "_wr_kernel" in k}
        k3 = _k3_usage()
        spills = [k for k, v in {**whole_row, **k3}.items()
                  if v.get("spill_stores") != 0 or v.get("spill_loads") != 0]
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                            if "registers" in ln or "spill" in ln][:40]
                        for n in names},
              "whole_row_registers": {k: v.get("registers")
                                      for k, v in sorted(whole_row.items())},
              "k3_registers": {k: v.get("registers")
                               for k, v in sorted(k3.items())},
              "spills": spills,
              "pass": bool(whole_row) and bool(k3) and not spills})
        if not whole_row or not k3 or spills:
            raise AssertionError(f"whole-row instances {len(whole_row)}, "
                                 f"K3 bf16 instances {len(k3)}, "
                                 f"spilling: {spills}")

        serve_path, train_path, rows = kernel_checks()
        engine, serve_launches = serve(repo)
        agreement(repo, engine)
        del engine
        torch.cuda.empty_cache()
        train_launches, tokens = train(repo)
        train_agreement(repo, tokens)
        torch.cuda.empty_cache()
        tools_launches = tools(repo)

        sources = {"attention_qkv": ("dist_tpu_torch/csrc/attention.cu",
                                     "dist_tpu/ops/attention.py:60"),
                   "temporal_net_fwd": ("dist_tpu_torch/csrc/temporal_net.cu",
                                        "dist_tpu/ops/temporal_net.py:161"),
                   "temporal_net_bwd": ("dist_tpu_torch/csrc/temporal_net.cu",
                                        "dist_tpu/ops/temporal_net.py:171")}
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        # "route" is the build route (cuda or triton); the attention
        # kernels' own route (whole_row, streaming, fp32) and the ptxas
        # usage of the instance the main path launches are beside it
        att_keys = ("attention_route", "blocks_per_sm", "ptxas")
        kernels = []
        for name, rec in train_path.items():
            entry = {"name": name, "route": "cuda",
                     "source": sources[name][0],
                     "replaces": sources[name][1],
                     "launches": train_launches[name],
                     **{k: rec[k] for k in keys},
                     "shape": rec["shape"], "dtype": rec["dtype"]}
            if name == "temporal_net_bwd":
                entry.update(_bwd_entry(rec))
                fp = rec["fp32_route"]
                entry["fp32_route"] = {"bwd_route": fp["route"],
                                       **{k: fp[k] for k in keys}}
            if name == "attention_qkv":
                entry.update(_attention_entry(rec, "attention_qkv_wr_kernel"))
                entry["streaming_ms"] = rec["streaming_ms"]
                long = rec["streaming_route"]
                entry["streaming_route"] = {
                    "shape": long["shape"], "attention_route": long["route"],
                    **{k: long[k] for k in keys}}
            if name in serve_path:
                srv = serve_path[name]
                entry["serving"] = {"launches": serve_launches[name],
                                    "shape": srv["shape"],
                                    **{k: srv[k] for k in keys}}
                if name == "attention_qkv":
                    entry["serving"].update({k: v for k, v in _attention_entry(
                        srv, "attention_qkv_wr_kernel").items()
                        if k in att_keys})
            entry["tools_launches"] = tools_launches[name]
            kernels.append(entry)
        # K4 runs only on the tools path: its launches are the tools
        # phase's, its numbers nb = 8's, each nb's beside them
        kernels.append({
            "name": "attention_qkv_rows", "route": "cuda",
            "source": "dist_tpu_torch/csrc/attention.cu",
            "replaces": "tools/microbench.py:154",
            "launches": tools_launches["attention_qkv_rows"],
            **{k: rows[8][k] for k in keys},
            "shape": rows[8]["shape"], "dtype": rows[8]["dtype"], "nb": 8,
            **_attention_entry(rows[8], "attention_rows_wr_kernel"),
            "per_nb": {str(nb): {k: rec[k] for k in (
                *keys, "k1_ms", "blocks", "blocks_per_sm",
                "smem_bytes_per_block", "equal_to_k1")}
                for nb, rec in rows.items()}})
        emit({"kernels": kernels})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # report the failing phase, exit non-zero
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
