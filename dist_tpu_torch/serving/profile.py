"""Where a served request's time goes on the card.

    python -m dist_tpu_torch.serving.profile [KEY VALUE ...]

Builds the ``InferenceEngine`` for the flagship DiST ViT-B/16 8+16f config
at batch 8, with the dotted overrides given (default:
``TPU.FUSED_TEMPORAL_NET true``), warms it up, times 5 batch-8 requests of
seeded random uint8 clips on the host clock, then traces as many again
with ``torch.profiler``. Prints one JSON line: the host time per request
untraced and traced (the profiler slows the host, not the card), the
device's busy time per request (the union of kernel and copy intervals on
the card), the idle share (busy time against the untraced host time; it
fails if the card was busy longer than that), and the device time per
kernel name, largest first, grouped into the port's kernels, GEMMs,
convolutions, copies and the rest.
"""

import json
import re
import sys
import time

import numpy as np
import torch

FLAGSHIP = "configs/projects/dist/ssv2/vit-b16-8+16f.yaml"
REQUESTS = 5
BATCH_SIZE = 8


def _group(name):
    n = name.lower()
    if "attention_rows" in n:
        return "K4 attention, nb rows per block (csrc/attention.cu)"
    if "attention_qkv" in n:
        return "K1 attention (csrc/attention.cu)"
    # K2: the fp32 route's two kernels; the bf16 route's prepare (its flag
    # true) and stages Af (4) and F (5) of the k3 kernels. K3: the rest
    if ("temporal_stage_kernel" in n or "spatial_stage_kernel" in n
            or re.search(r"k3_prepare_kernel<\d+, true>"
                         r"|k3_stage_kernel<\d+, [45]>", n)):
        return "K2 TemporalNet (csrc/temporal_net.cu)"
    if "k3_" in n:
        return "K3 TemporalNet backward (csrc/temporal_net.cu)"
    # cuDNN's convolutions are implicit GEMMs ("fprop"): test them first
    if "fprop" in n or "conv" in n or "cudnn" in n:
        return "convolution (cuDNN)"
    if "gemm" in n or "nvjet" in n or "cutlass" in n or "cublas" in n:
        return "GEMM (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    return "other elementwise/reduction"


def _busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    from torch.profiler import ProfilerActivity, profile

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.engine import InferenceEngine

    opts = sys.argv[1:] or ["TPU.FUSED_TEMPORAL_NET", "true"]
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA card")

    cfg = load_config(FLAGSHIP, opts, make_output_dir=False)
    engine = InferenceEngine(cfg, batch_size=BATCH_SIZE)
    engine.warmup()
    rng = np.random.default_rng(int(cfg.RANDOM_SEED))
    clips = rng.integers(0, 256, (BATCH_SIZE, engine.num_frames,
                                  engine.crop, engine.crop, 3), dtype=np.uint8)
    engine.predict(clips)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            engine.predict(clips)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    wall_us = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_us = run()

    per_name, groups, intervals = {}, {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        intervals.append((ev.time_range.start, ev.time_range.end))
        per_name[ev.name] = per_name.get(ev.name, 0.0) + dur
        g = _group(ev.name)
        groups[g] = groups.get(g, 0.0) + dur
    busy = _busy_us(intervals)
    if busy > wall_us:
        raise SystemExit(f"profile: the card was busy {busy:.0f} us in the "
                         f"traced run, longer than the untraced run's "
                         f"{wall_us:.0f} us; the idle share is undefined")
    n = REQUESTS
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:15]
    print(json.dumps({
        "config": FLAGSHIP, "overrides": opts,
        "card": torch.cuda.get_device_name(0),
        "batch_size": BATCH_SIZE, "requests": n,
        "host_ms_per_request": wall_us / n / 1e3,
        "traced_host_ms_per_request": traced_us / n / 1e3,
        "device_busy_ms_per_request": busy / n / 1e3,
        "device_idle_share": 1.0 - busy / wall_us,
        "device_ms_per_request_by_group": {
            k: v / n / 1e3 for k, v in sorted(groups.items(),
                                              key=lambda kv: -kv[1])},
        "top_kernels_ms_per_request": [[k[:90], v / n / 1e3] for k, v in top],
        "device_events": len(intervals),
    }))


if __name__ == "__main__":
    main()
