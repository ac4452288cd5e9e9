"""A training cell: the program's train loop, ``tasks/train.py::
train_epoch``, fed by a loader of the benchmark's own from a pool of
pinned host batches, each copied to the card by the loop, its metrics
read back one step late.

Set-up builds one train state (model, AdamW, step), makes the weights,
label texts and pool from the seed, and drives the state through its
first ``check_steps`` steps on pool batches that all differ, through the
same loop and feed as the window. Their losses, the first gradient (from
AdamW's first moment after one step) and the weights' change over them
are kept as norms; the same object then trains through ``warm_steps``
more and the window. After the window, with the program's state freed,
the reference follows the first steps from the same weights and
batches."""

import gc
import itertools

import numpy as np
import torch

from benchmark import checks, flops, harness, weights
from benchmark.reference import train as ref_train
from benchmark.reference.precision import Precision, tf32_off


class Feed:
    """The loader: host batches {"video": pinned uint8, "label": int64},
    cycled; ``before(i)``, run on the loop's thread before batch ``i`` is
    handed over, ends the feed by returning False."""

    def __init__(self, batches, before):
        self.batches = batches
        self.before = before

    def __iter__(self):
        for i in itertools.count():
            if not self.before(i):
                return
            yield self.batches[i % len(self.batches)]


class Recorder:
    """The step as the loop calls it: the program's step, with the host's
    time inside each call (the enqueue, before any synchronisation) and
    the losses kept while ``keep`` is set."""

    def __init__(self, step):
        self.step = step
        self.host_s = []
        self.losses = []
        self.keep = False

    def __call__(self, state, batch):
        t = harness.now()
        m = self.step(state, batch)
        self.host_s.append(harness.now() - t)
        if self.keep:
            self.losses.append(m["loss"])
        return m


def _pool(run, device):
    """``pool_batches`` host batches of the configuration's batch, made
    on the device from the seed, copied to pinned host memory."""
    spec, t = run.spec, run.traffic
    b = run.config["batch"]
    n = t["pool_batches"] * b
    clips = weights.make_clips(n, spec["num_frames"], spec["crop"],
                               run.seed + 1, device)
    labels = weights.make_labels(n, spec["classes"], run.seed + 2, device)
    clips, labels = clips.cpu(), labels.cpu()
    if device.type == "cuda":
        clips, labels = clips.pin_memory(), labels.pin_memory()
    return [{"video": clips[i * b:(i + 1) * b], "label": labels[i * b:(i + 1) * b]}
            for i in range(t["pool_batches"])]


def _setup(run):
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.tasks.state import (
        compute_text_features, create_train_state, ema_decay, make_train_step)

    device = run.device
    cfg = harness.program_config(run)
    spec = run.spec
    harness.note("set-up: imports and configuration done")
    model = build_model(cfg, device=device)
    harness.note("set-up: model built")
    w0 = weights.make_weights(spec, run.seed, device)
    model.module.load_state_dict(w0, strict=True)
    steps_per_epoch = int(cfg.TRAIN.NUM_FOLDS) * spec["train"]["steps_per_epoch"]
    optimizer, lr_fn = construct_optimizer(cfg, model.module, steps_per_epoch)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    step = Recorder(make_train_step(model, cfg, optimizer, lr_fn))
    text = None
    if spec["head"] == "text":
        text = compute_text_features(
            model, weights.make_tokens(spec, run.seed, device))
    harness.note("set-up: weights, optimizer and label features")
    return cfg, model, optimizer, state, step, text, w0


def _first_steps(run, cfg, model, optimizer, state, step, text, w0, pool,
                 meter):
    """The check steps through the loop; returns their losses and norms."""
    from dist_tpu_torch.tasks.train import train_epoch

    n = run.traffic["check_steps"]
    beta1 = optimizer.param_groups[0]["betas"][0]
    trained = {name: p for name, p in model.module.named_parameters()
               if p.requires_grad}
    out = {}

    def before(i):
        if i == 1:
            # after the first step: the gradient AdamW was given
            st = optimizer.state
            out["grad_norm"] = {
                k: torch.linalg.vector_norm(st[p]["exp_avg"]) / (1 - beta1)
                for k, p in trained.items() if p in st}
        if i == n:
            out["change_norm"] = {
                k: torch.linalg.vector_norm(p.detach() - w0[k])
                for k, p in trained.items()}
            return False
        return True

    step.keep = True
    train_epoch(cfg, state, step, Feed(pool, before), meter, 0, text)
    step.keep = False
    return {"loss": [float(v) for v in step.losses],
            "grad_norm": {k: float(v) for k, v in out["grad_norm"].items()},
            "change_norm": {k: float(v) for k, v in out["change_norm"].items()}}


def run_train(run):
    """Set-up, the check steps, the window and the comparison; returns
    (the memory peak before the reference, the numbers compared)."""
    from dist_tpu_torch.tasks.train import train_epoch
    from dist_tpu_torch.utils.meters import TrainMeter

    from benchmark import trace as tr

    device, t = run.device, run.traffic
    cfg, model, optimizer, state, step, text, w0 = _setup(run)
    pool = _pool(run, device)
    harness.note("set-up: input pool")
    meter = TrainMeter(10 ** 6, cfg)
    prog = _first_steps(run, cfg, model, optimizer, state, step, text, w0,
                        pool[:t["check_steps"]], meter)
    harness.note("set-up: check steps")
    del w0
    b = run.config["batch"]
    stretch = tr.Stretch(device) if run.traced else None
    if stretch is not None:
        stretch.warm()
    harness.settle()
    win = {"steps": 0}
    cuda = device.type == "cuda"

    def before(i):
        if i < t["warm_steps"]:
            return True
        k = i - t["warm_steps"]
        if k == 0:
            if cuda:
                torch.cuda.synchronize(device)
                win["setup_peak"] = torch.cuda.max_memory_allocated(device)
                torch.cuda.reset_peak_memory_stats(device)
            win["t0"] = harness.now()
            win["host0"] = len(step.host_s)
        elif harness.now() - win["t0"] >= run.seconds:
            if stretch is not None and stretch.running:
                stretch.stop()
            return False
        if stretch is not None:
            if k == t["trace_skip_steps"]:
                stretch.start()
            elif stretch.running and len(stretch.batches) == t["trace_steps"]:
                stretch.stop()
            if stretch.running:
                stretch.batches.append(b)
        win["steps"] = k + 1
        return True

    if run.seconds > 0:
        train_epoch(cfg, state, step, Feed(pool, before), meter, 0, text)
        if cuda:
            torch.cuda.synchronize(device)
        t1 = harness.now()
        window_s = t1 - win["t0"]
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        run.window = {"seconds": window_s, "steps": win["steps"],
                      "clips": win["steps"] * b, "peak": peak,
                      "setup_s": win["t0"] - run.t_start}
        host = step.host_s[win["host0"]:]
        if stretch is not None and stretch.t_begin is not None:
            # the stretch's steps and seconds are the profiler's: the
            # window's other steps give the host's time and the rate
            skip, n = t["trace_skip_steps"], len(stretch.batches)
            host = host[:skip] + host[skip + n:]
            run.window["untraced_steps"] = win["steps"] - n
            run.window["untraced_s"] = window_s - (stretch.t_end - stretch.t_begin)
        run.spans["host_s"] = host
    if stretch is not None and stretch.t_end is not None:
        from benchmark import spec

        run.trace = stretch.reduce(spec.all_ranges(run.root))
    result_peak = max(run.window.get("peak", 0), win.get("setup_peak", 0))

    # the program's state goes before the reference runs
    del model, optimizer, state, step, meter
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = compare(run, pool, prog)
    return result_peak, numbers


def reference_steps(run, pool, precision="float32", fault=None):
    """The reference's first steps on the check batches."""
    spec, device = run.spec, run.device
    w = weights.make_weights(spec, run.seed, device)
    batches = [{"video": p["video"].to(device), "labels": p["label"].to(device)}
               for p in pool[:run.traffic["check_steps"]]]
    tokens = (weights.make_tokens(spec, run.seed, device)
              if spec["head"] == "text" else None)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    tf32_off()
    try:
        return ref_train.run_steps(Precision(precision), w, batches, spec,
                                   run.cfg_seed, tokens=tokens, fault=fault)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def compare(run, pool, prog):
    t = harness.now()
    ref = reference_steps(run, pool)
    worst = {}
    numbers = checks.train_numbers(prog, ref, worst)
    harness.note(f"reference {harness.now() - t:.2f} s; worst leaves {worst}; "
                 f"losses {prog['loss']} against {ref['loss']}")
    return numbers


def step_flops(run):
    return run.config["batch"] * flops.clip_flops(run.spec, train=True)


def host_ms_per_step(run):
    s = run.spans.get("host_s")
    return 1e3 * float(np.mean(s)) if s else None
