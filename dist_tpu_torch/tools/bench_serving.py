"""Latency and throughput of the serving path on the card (port of
``tools/bench_serving.py``).

    python -m dist_tpu_torch.tools.bench_serving [--cfg CFG] [--batch 8]
        [--iters 50] [--load-seconds 10] [--max-delay-ms 10]
        [--device cpu] [KEY VALUE ...]

Drives ``dist_tpu_torch.serving`` as a deployment would, the
``InferenceEngine``'s buckets through the ``MicroBatcher``, and prints one
JSON object:

- batch-1 and full-batch request latency (p50 / p99) through the engine,
  and the full batch's clips/s;
- the bucketed batch-1 request against the same clip padded to the full
  batch (what ``InferenceEngine.buckets`` saves);
- batch-1 through the MicroBatcher at low occupancy (adds the batching
  delay budget), and sustained clips/s under saturating load from
  2 x batch client threads;
- the device step alone (the engine's eval step on clips already on the
  card, ended by copying the scores to the host) and the upload of the
  uint8 clips (``torch.from_numpy(a).to(device)`` and a synchronisation).

Latencies are host-clock ms. Runs on the CUDA card; ``--device cpu`` runs
on the CPU, where the times are the CPU's.
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _percentiles(samples_ms):
    a = np.asarray(samples_ms)
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)),
            "mean_ms": float(a.mean())}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.bench_serving",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cfg",
                    default="configs/projects/dist/ssv2/vit-b16-8+16f.yaml")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--load-seconds", type=float, default=10.0)
    ap.add_argument("--max-delay-ms", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving import InferenceEngine, MicroBatcher

    cfg_path = (args.cfg if os.path.isabs(args.cfg)
                else os.path.join(REPO, args.cfg))
    cfg = load_config(cfg_path, list(args.opts), make_output_dir=False)
    engine = InferenceEngine(cfg, batch_size=args.batch, device=args.device)
    device = engine.device
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0

    shape = (engine.num_frames, engine.crop, engine.crop, 3)
    clip1 = np.random.default_rng(0).integers(0, 255, (1,) + shape, np.uint8)
    clip_full = np.broadcast_to(clip1, (args.batch,) + shape).copy()

    def wait():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, n):
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
        return ts

    # batch-1 requests (bucket 1), then the same clip padded to the full
    # bucket
    lat1 = timed(lambda: engine.predict(clip1), args.iters)
    lat_pad = timed(lambda: engine.predict(clip_full), args.iters)

    # predict = upload + device step + score copy to the host; the upload
    # and the step alone
    def h2d(arr):
        torch.from_numpy(arr).to(device)
        wait()

    h2d_1 = timed(lambda: h2d(clip1), max(10, args.iters // 5))
    h2d_full = timed(lambda: h2d(clip_full), max(10, args.iters // 5))

    def device_step(clips):
        batch = {"video": torch.from_numpy(clips).to(device),
                 "text_features": engine.text_features}
        step = engine.replicas.steps[0]
        wait()
        return timed(lambda: step(batch)["preds"].float().cpu(), args.iters)

    dev1 = device_step(clip1)
    dev_full = device_step(clip_full)

    # the MicroBatcher: batch-1 at low occupancy, then saturating load
    batcher = MicroBatcher(engine.predict, max_batch=args.batch,
                           max_delay_ms=args.max_delay_ms)
    try:
        lat_mb = timed(lambda: batcher.submit(clip1[0]).result(timeout=120),
                       args.iters)
        stop = threading.Event()
        done = [0]
        lock = threading.Lock()
        failures = []

        def client():
            try:
                while not stop.is_set():
                    futs = [batcher.submit(clip1[0]) for _ in range(4)]
                    for f in futs:
                        f.result(timeout=120)
                    with lock:
                        done[0] += len(futs)
            except Exception as e:  # reported below
                failures.append(repr(e))

        clients = [threading.Thread(target=client)
                   for _ in range(2 * args.batch)]
        t0 = time.perf_counter()
        for c in clients:
            c.start()
        time.sleep(args.load_seconds)
        stop.set()
        for c in clients:
            c.join(timeout=120)
        dt = time.perf_counter() - t0
    finally:
        batcher.close()
    if failures or any(c.is_alive() for c in clients):
        raise RuntimeError(f"load clients failed: {failures[:3]}")

    clip_mb = clip1.nbytes / 2 ** 20
    result = {
        "config": os.path.relpath(cfg_path, REPO),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "batch_size": args.batch,
        "buckets": engine.buckets(),
        "warmup_s": warmup_s,
        "engine_batch1": _percentiles(lat1),
        "engine_full_batch": dict(
            _percentiles(lat_pad),
            clips_per_sec=args.batch * 1e3 / float(np.mean(lat_pad))),
        "batch1_bucketed_vs_padded_speedup":
            float(np.mean(lat_pad)) / float(np.mean(lat1)),
        "microbatcher_batch1": _percentiles(lat_mb),
        "sustained_load": {"clients": 2 * args.batch,
                           "clips_per_sec": done[0] / dt, "seconds": dt},
        "device_step_batch1": _percentiles(dev1),
        "device_step_full_batch": dict(
            _percentiles(dev_full),
            clips_per_sec=args.batch * 1e3 / float(np.mean(dev_full))),
        "h2d_upload_batch1": dict(_percentiles(h2d_1), mb=clip_mb),
        "h2d_upload_full_batch": dict(
            _percentiles(h2d_full), mb=clip_mb * args.batch,
            mb_per_s=clip_mb * args.batch * 1e3 / float(np.mean(h2d_full))),
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
