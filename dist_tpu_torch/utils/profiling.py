"""Profiling and timing helpers (port of ``dist_tpu/utils/profiling.py``).

- :func:`trace` — a context manager around ``torch.profiler`` that writes
  a Chrome trace of the CPU and, where there is a card, its kernels into
  ``log_dir``;
- :func:`sync` — wait for the work queued on a tensor's card;
- :func:`step_timer` — host-clock timing of a block, synchronised with the
  card at its end;
- :func:`time_calls` — a function's first call and its mean time per call
  after warm-up, between CUDA events on a card;
- :func:`device_memory_stats` — ``torch.cuda.memory_stats`` per card.
"""

import contextlib
import os
import time

import torch

from dist_tpu_torch.utils import logging

logger = logging.get_logger(__name__)


@contextlib.contextmanager
def trace(log_dir):
    """Capture a trace: ``with trace(dir): run_steps()``; the Chrome trace
    is ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        logger.info("profiler trace started -> %s", log_dir)
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


def sync(tree):
    """Wait until the card that holds the first tensor of ``tree`` (a
    tensor, or a list, tuple or dict of them) has finished its queued
    work; a CPU tensor needs no wait. Returns ``tree``."""
    leaf = tree
    while isinstance(leaf, (list, tuple, dict)):
        leaf = next(iter(leaf.values() if isinstance(leaf, dict) else leaf))
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return tree


@contextlib.contextmanager
def step_timer(name="step", result=None):
    """Time a block on the host clock; put the block's output in
    ``box["output"]`` to wait for its card before the clock stops.
    Appends the seconds to ``result`` (a list) when given."""
    t0 = time.perf_counter()
    box = {}
    yield box
    if "output" in box:
        sync(box["output"])
    dt = time.perf_counter() - t0
    if result is not None:
        result.append(dt)
    logger.info("%s: %.2f ms", name, dt * 1e3)


def time_calls(fn, device, reps, outer=1, warmup=2):
    """(first_call_s, ms): the seconds of the first call of ``fn`` (on the
    card it includes a kernel's build at first use and cuDNN's autotuning)
    and, after ``warmup`` more calls, the mean ms per call over ``outer``
    runs of ``reps`` calls. On a card the runs lie between CUDA events; on
    the CPU the host clock times them."""
    cuda = torch.device(device).type == "cuda"

    def wait():
        if cuda:
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    fn()
    wait()
    first = time.perf_counter() - t0
    for _ in range(warmup):
        fn()
    wait()
    n = reps * outer
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return first, start.elapsed_time(end) / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return first, (time.perf_counter() - t0) * 1e3 / n


def device_memory_stats():
    """{"cuda:i": torch.cuda.memory_stats(i)} for every card; empty
    without one."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
