"""A serving cell: an open loop of single-clip requests through the
program's ``serving/batcher.py::MicroBatcher`` over
``serving/engine.py::InferenceEngine.predict``.

Arrivals: exactly ``rate * seconds`` requests, their times uniform over
the window and sorted (a Poisson stream given its count), each for a clip
drawn from a pool made from the seed: every seed sends the same amount of
work in another order. Each request is timed from when it was due to
when its score row is ready; one that is refused or never answered is
missing. After the window every request is waited for, a minute past
the close at most.

The check: a sample of the answered requests, drawn from the seed, each
row held to the reference's scores of the same clip."""

import gc
import queue
import time

import numpy as np
import torch

from benchmark import checks, flops, harness, weights
from benchmark.reference.model import logits, normalize_video, text_tower
from benchmark.reference.precision import Precision, tf32_off

WAIT_AFTER_S = 60.0


class Predict:
    """``predict_fn`` as the batcher calls it: the engine's predict, with
    the traced stretch run on the batcher's thread, which drives the
    device: started at the first batch after ``trace_from``, ended before
    the batch after ``trace_batches`` batches or the window's close, each
    of its batches' bucket kept. The profiler itself is stopped by one
    more request after the window (``flush``), so that its seconds of
    reduction hold up no request of the window."""

    def __init__(self, engine, stretch=None):
        self.engine = engine
        self.stretch = stretch
        self.trace_from = self.close = None     # host clock
        self.trace_batches = 0

    def bucket(self, n):
        return next(b for b in self.engine.buckets() if b >= n)

    def __call__(self, clips):
        s = self.stretch
        if s is not None and self.trace_from is not None:
            now = harness.now()
            if s.prof is None and self.trace_from <= now < self.close:
                s.start()
            elif s.running and (len(s.batches) >= self.trace_batches
                                or now >= self.close):
                s.end()
            if s.running:
                s.batches.append(self.bucket(len(clips)))
        out = self.engine.predict(clips)
        if s is not None and s.prof is not None and self.trace_from is None:
            s.stop()
        return out

    def flush(self, batcher, clip):
        """After the window: one request that stops the profiler on the
        batcher's thread."""
        if self.stretch is not None and self.stretch.prof is not None:
            self.trace_from = None
            batcher.submit(clip).result(timeout=WAIT_AFTER_S)


def setup(run):
    """The engine with the seed's weights and label texts, warmed up on
    every bucket the traffic uses, and the clip pool (numpy, host)."""
    from dist_tpu_torch.serving.engine import InferenceEngine
    from dist_tpu_torch.tasks.state import compute_text_features

    spec, device = run.spec, run.device
    cfg = harness.program_config(run)
    harness.note("set-up: imports and configuration done")
    engine = InferenceEngine(cfg, batch_size=run.config["serve_batch"],
                             device=str(device))
    harness.note("set-up: engine built")
    engine.load_state_dict(weights.make_weights(spec, run.seed, device))
    engine.text_features = compute_text_features(
        engine.model, weights.make_tokens(spec, run.seed, device))
    harness.note("set-up: weights and label features")
    for _ in range(2):
        engine.warmup()
    harness.note("set-up: every bucket warmed up")
    pool = weights.make_clips(run.traffic["pool_clips"], spec["num_frames"],
                              spec["crop"], run.seed + 1, device).cpu().numpy()
    return engine, pool


def schedule(run, rate, seconds):
    """(due times from the window's start, clip of each request)."""
    rng = np.random.default_rng([int(run.seed), 2])
    n = int(round(rate * seconds))
    due = np.sort(rng.uniform(0.0, seconds, n))
    clip = rng.integers(0, run.traffic["pool_clips"], n)
    return due, clip


def open_loop(batcher, pool, due, clip, t0):
    """Send each request when due; returns (futures or None, done times,
    the generator's largest lateness in s)."""
    n = len(due)
    done = [None] * n
    futs = [None] * n
    late = 0.0
    for i in range(n):
        wait = t0 + due[i] - harness.now()
        if wait > 0:
            time.sleep(wait)
        late = max(late, harness.now() - (t0 + due[i]))
        try:
            f = batcher.submit(pool[clip[i]])
        except (queue.Full, RuntimeError):
            continue
        futs[i] = f
        f.add_done_callback(lambda _f, i=i: done.__setitem__(i, harness.now()))
    return futs, done, late


def window(run, batcher, pool, rate, seconds):
    """One window at ``rate``: latencies (None for a missing request),
    the backlog at the close, the generator's lateness."""
    due, clip = schedule(run, rate, seconds)
    t0 = harness.now()
    stats0 = batcher.snapshot()
    futs, done, late = open_loop(batcher, pool, due, clip, t0)
    close = t0 + seconds
    if close > harness.now():
        time.sleep(close - harness.now())
    backlog = sum(1 for f, d in zip(futs, done)
                  if f is not None and (d is None or d > close))
    for f in futs:
        if f is not None:
            try:
                f.result(timeout=max(0.0, close + WAIT_AFTER_S - harness.now()))
            except Exception:      # a failed or late answer is missing
                pass
    stats1 = batcher.snapshot()
    lat = [None if d is None or f is None or not f.done() or f.exception()
           else d - (t0 + due[i]) for i, (f, d) in enumerate(zip(futs, done))]
    return {"t0": t0, "seconds": seconds, "latency_s": lat, "due": due,
            "backlog": backlog,
            "late_s": late, "futures": futs, "clip": clip,
            "batches": stats1["batches"] - stats0["batches"],
            "batched": stats1["batched_clips"] - stats0["batched_clips"]}


def run_serve(run):
    from dist_tpu_torch.serving.batcher import MicroBatcher

    from benchmark import trace as tr

    device, t = run.device, run.traffic
    engine, pool = setup(run)
    stretch = tr.Stretch(device) if run.traced else None
    if stretch is not None:
        stretch.warm()
    pred = Predict(engine, stretch)
    batcher = MicroBatcher(pred, max_batch=run.config["serve_batch"],
                           max_delay_ms=run.config["max_delay_ms"])
    cuda = device.type == "cuda"
    harness.settle()
    try:
        if cuda:
            torch.cuda.synchronize(device)
            setup_peak = torch.cuda.max_memory_allocated(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = harness.now()
        if stretch is not None:
            pred.trace_from = t0 + t["trace_after"] * run.seconds
            pred.close = t0 + run.seconds
            pred.trace_batches = t["trace_batches"]
        w = window(run, batcher, pool, t["rate"], run.seconds)
        pred.flush(batcher, pool[0])
    finally:
        batcher.close()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.window = dict(w, setup_s=w["t0"] - run.t_start, peak=peak)
    if stretch is not None:
        run.window["stretch_begin"] = stretch.t_begin
    if stretch is not None and stretch.t_end is not None:
        from benchmark import spec

        run.trace = stretch.reduce(spec.all_ranges(run.root))
    served = _sample(run, w)
    del engine, batcher, pred
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = harness.now()
    numbers = {"score_gap": checks.score_gap(
        np.stack([row for _, row in served]) if served else np.zeros((0,)),
        reference_scores(run, pool, [c for c, _ in served]))}
    harness.note(f"reference {harness.now() - t_ref:.2f} s over {len(served)} "
                 f"answers; generator late by {1e3 * w['late_s']:.3f} ms at most; "
                 f"backlog at the close {w['backlog']}")
    missing = sum(1 for x in w["latency_s"] if x is None)
    return max(peak, setup_peak if cuda else 0), numbers, missing


def _sample(run, w):
    """[(clip, served row)] of up to ``check_sample`` answered requests,
    drawn from the seed."""
    answered = [i for i, x in enumerate(w["latency_s"]) if x is not None]
    rng = np.random.default_rng([int(run.seed), 3])
    k = min(run.traffic["check_sample"], len(answered))
    pick = sorted(rng.choice(answered, k, replace=False)) if k else []
    return [(int(w["clip"][i]), w["futures"][i].result()) for i in pick]


def reference_scores(run, pool, clip_ids, precision="float32"):
    """The reference's score rows of the pool's clips ``clip_ids``, in
    blocks of ``block`` clips."""
    spec, device = run.spec, run.device
    if not clip_ids:
        return np.zeros((0,))
    w = weights.make_weights(spec, run.seed, device)
    P = Precision(precision)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32_off()
    try:
        with torch.no_grad():
            text = text_tower(P, weights.make_tokens(spec, run.seed, device),
                              w, spec["arch"])
            uniq = sorted(set(clip_ids))
            rows = {}
            blk = run.traffic["ref_block"]
            for lo in range(0, len(uniq), blk):
                ids = uniq[lo:lo + blk]
                video = torch.from_numpy(pool[ids]).to(device)
                out = logits(P, normalize_video(video, spec["mean"], spec["std"]),
                             w, spec, text)
                for i, r in zip(ids, torch.softmax(out.float(), -1).cpu().numpy()):
                    rows[i] = r
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return np.stack([rows[i] for i in clip_ids])


def serve_flops(run):
    """Operations of the window's answered requests."""
    n = sum(1 for x in run.window["latency_s"] if x is not None)
    return n * flops.clip_flops(run.spec, train=False)


def percentile_ms(run, q, before=None):
    """The ``q``-th percentile of the window's latencies in ms (of the
    requests due before the host time ``before``, where given); None if
    one is missing."""
    lat = run.window["latency_s"]
    if before is not None:
        due = run.window["t0"] + run.window["due"]
        lat = [x for x, d in zip(lat, due) if d < before]
    vals = sorted(x for x in lat if x is not None)
    if not vals or len(vals) < len(lat):
        return None
    return 1e3 * float(np.percentile(vals, q))
