#!/usr/bin/env python3
"""Drive the PyTorch port (``dist_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

1. Card: prints the card's name and power limit, builds the hand-written
   CUDA kernels from ``dist_tpu_torch/csrc`` with nvcc (in parallel).
2. Kernels: calls each kernel on the card at the shapes the serving path
   gives it and holds it against its plain PyTorch version on the same
   inputs (TF32 off), with the tolerance stated beside each check; times
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (``library_ms``), with CUDA events after
   warm-up.
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

Prints one JSON line per check and phase, then ``{"kernels": [...]}``,
the card line, and last ``{"ok": true, "device": {...}}``. Any failure,
or no CUDA card, exits non-zero without the last line.
"""

import json
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
    warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
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


def check_attention(name, b, l, heads, hd, causal, dtype, seed):
    import torch
    import torch.nn.functional as F
    from dist_tpu_torch.ops import attention as att

    d = heads * hd
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, l, 3 * d), generator=gen, device="cuda").to(dtype)
    got = att.fused_attention_qkv(qkv, heads, causal)
    want = att.attention_qkv_plain(qkv, heads, causal)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        # fp32 on both sides; sums of <= 257 terms in another order
        atol, rtol, why = 2e-5, 1e-5, "fp32 summation order"
    else:
        # P is rounded to bf16 on both sides from fp32 values that may
        # differ in the last bit: a flip moves O by <= 2^-8 * max|V|; O
        # itself is rounded to bf16, one step <= 2^-7 relative
        vmax = float(qkv[..., 2 * d:].float().abs().max())
        atol, rtol, why = 2 ** -8 * vmax, 2 ** -7, "bf16 rounding of P and O"
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
        "max_abs_err": err, "atol": atol, "rtol": rtol, "tolerance": why,
        "ms": time_ms(lambda: att.fused_attention_qkv(qkv, heads, causal), 20),
        "plain_ms": time_ms(
            lambda: att.attention_qkv_plain(qkv, heads, causal), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), 20),
        "bound_ms": b_ms, "bound_by": b_by, "pass": ok,
    }
    emit(rec)
    if not ok:
        raise AssertionError(f"{name}: kernel and plain version disagree "
                             f"(max abs err {err})")
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


def kernel_checks():
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    att = [
        check_attention("attention vision fp32", 64, 197, 12, 64, False, f32, 1),
        check_attention("attention vision bf16", 64, 197, 12, 64, False, bf16, 2),
        check_attention("attention text causal bf16", 174, 77, 8, 64, True,
                        bf16, 3),
        check_attention("attention L/14 bf16", 16, 257, 16, 64, False, bf16, 4),
    ]
    tnet = [
        check_temporal_net("temporal_net fp32", (8, 16, 14, 14, 96), f32, 5),
        check_temporal_net("temporal_net bf16", (8, 16, 14, 14, 96), bf16, 6),
    ]
    # the shapes and type of the served model's main path
    return {"attention_qkv": att[1], "temporal_net_fwd": tnet[1]}


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
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "ptxas": {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                            if "registers" in ln or "spill" in ln][:12]
                        for n in names}})

        main_path = kernel_checks()
        engine, launches = serve(repo)
        agreement(repo, engine)

        sources = {"attention_qkv": ("dist_tpu_torch/csrc/attention.cu",
                                     "dist_tpu/ops/attention.py:60"),
                   "temporal_net_fwd": ("dist_tpu_torch/csrc/temporal_net.cu",
                                        "dist_tpu/ops/temporal_net.py:161")}
        kernels = []
        for name, rec in main_path.items():
            kernels.append({
                "name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1], "launches": launches[name],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "shape": rec["shape"], "dtype": rec["dtype"]})
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
