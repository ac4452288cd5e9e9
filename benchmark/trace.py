"""The traced stretch: ``torch.profiler`` over a bounded steady stretch of
the window, marked by the range ``bench_window``, and its reduction.

- ``busy_s``: the union of the device's operations (kernels, copies,
  sets) inside the stretch; ``window_s`` its length; the idle share is
  the rest.
- ``range_s``: for each named range (an operator, a backward node), the
  device time of the kernels launched while a range of that name was
  open on the launching thread.
- ``breakdown``: the device operations by name that took most time, and
  the longest idle gaps, each named by the innermost host event open
  across the gap's middle on any thread.

The profile is written once as a Chrome trace under ``TMPDIR``, read and
deleted."""

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Stretch:
    """Starts and stops the profiler around a stretch of a run, from the
    thread that drives the device."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t_begin = self.t_end = None    # host clock around the stretch
        self._range = None
        self.batches = []

    def start(self):
        from torch.profiler import profile

        self.t_begin = time.perf_counter()
        self.prof = profile(activities=_activities(self.device))
        self.prof.start()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()

    def end(self):
        """Close the stretch's range; the profiler records on until
        :meth:`stop`, whose reduction of the events holds the interpreter
        for seconds (a serving run stops it after its window)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self.t_end = time.perf_counter()

    def stop(self):
        """End the stretch if it runs, then the profiler; on the thread
        that started it."""
        if self.running:
            self.end()
        self.prof.stop()

    @property
    def running(self):
        return self.prof is not None and self.t_end is None

    def warm(self):
        """Start and stop the profiler once on a small device operation,
        so that its own start-up is set-up and not in the stretch."""
        from torch.profiler import profile

        with profile(activities=_activities(self.device)):
            torch.ones(1024, device=self.device).sum().item()

    def reduce(self, ranges):
        """A :class:`Trace` of the stretch, with the device time under
        each of ``ranges``."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            with contextlib.suppress(OSError):
                os.remove(path)
        return Trace(events, ranges, self.batches)


def _activities(device):
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events, ranges, batches):
        self.batches = list(batches)
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        win = [e for e in xs if e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
        if not win:
            raise RuntimeError("the traced stretch has no bench_window range")
        lo = float(win[0]["ts"])
        hi = lo + float(win[0]["dur"])
        self.window_s = (hi - lo) * 1e-6
        dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
        spans = [(max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi))
                 for e in dev]
        busy = _merge([s for s in spans if s[1] > s[0]])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6

        by_name = collections.Counter()
        for e in dev:
            by_name[e["name"][:160]] += float(e["dur"]) * 1e-6
        self.device_ops = by_name.most_common(10)

        host = [e for e in xs if e.get("cat") in HOST_CATS
                and e.get("name") != WINDOW]
        gaps = []
        prev = lo
        for a, b in busy + [[hi, hi]]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        self.idle_gaps = [[self._host_at(host, (a + b) / 2), (b - a) * 1e-6]
                          for a, b in gaps[:10]]

        self.range_s = self._range_device_s(xs, dev, ranges, lo, hi)

    @staticmethod
    def _host_at(host, t):
        inside = [e for e in host
                  if float(e["ts"]) <= t <= float(e["ts"]) + float(e["dur"])]
        if not inside:
            return "host: no traced event"
        e = min(inside, key=lambda e: float(e["dur"]))
        return e["name"][:160]

    @staticmethod
    def _range_device_s(xs, dev, ranges, lo, hi):
        """{range: device seconds of the kernels launched inside it}."""
        opened = collections.defaultdict(list)       # (pid, tid) -> spans
        for e in xs:
            # the ranges that open inside the stretch: the profiler may
            # record on after it
            if (e.get("name") in ranges and lo <= float(e["ts"]) <= hi
                    and e.get("cat") in ("cpu_op", "user_annotation")):
                opened[(e["pid"], e["tid"])].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]))
        for v in opened.values():
            v.sort()
        starts = {k: [s[0] for s in v] for k, v in opened.items()}
        launches = {}
        for e in xs:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        out = {r: 0.0 for r in ranges}
        for k in dev:
            corr = (k.get("args") or {}).get("correlation")
            launch = launches.get(corr)
            if launch is None:
                continue
            key = (launch["pid"], launch["tid"])
            spans = opened.get(key)
            if not spans:
                continue
            t = float(launch["ts"])
            # the listed ranges do not nest: the last one to open before
            # the launch is the only one that can hold it
            i = bisect.bisect_right(starts[key], t)
            if i and t <= spans[i - 1][1]:
                out[spans[i - 1][2]] += float(k["dur"]) * 1e-6
        return out
