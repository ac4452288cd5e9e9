"""Cross-request micro-batching (port of ``dist_tpu/serving/batcher.py``;
the same code, in the port's own copy).

The card's throughput comes from batched work: serving one clip at a time
wastes (batch-1)/batch of every step. The batcher glues concurrent
requests into device batches under a latency deadline:

- the dispatch loop blocks for the first request, then drains the queue
  until ``max_batch`` clips are in hand OR ``max_delay_ms`` has elapsed
  since the first one — the standard throughput/latency dial;
- ONE device call serves the whole batch; per-request results resolve
  through ``concurrent.futures.Future``s, so any number of server threads
  can wait without touching the device;
- the device is only ever driven from the single dispatch thread (one
  thread queues all the card's work, in order).

Standard library and numpy only.
"""

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class MicroBatcher:
    """predict_fn: ``uint8 (n, ...) -> scores (n, C)`` (e.g.
    ``InferenceEngine.predict``). ``submit`` one clip ``(...)``, get a
    Future of its ``(C,)`` score row."""

    def __init__(self, predict_fn, max_batch=8, max_delay_ms=10.0,
                 max_queue=None):
        self._predict = predict_fn
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay_ms) / 1000.0
        # BOUNDED queue = backpressure: under overload submit fails fast
        # (the server maps it to 503) instead of buffering clips and device
        # work without limit until OOM
        self._q = queue.Queue(maxsize=int(max_queue or 32 * self.max_batch))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_clips": 0,
                      "errors": 0, "rejected": 0, "latency_ms_sum": 0.0,
                      "latency_ms_max": 0.0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="microbatcher")
        self._thread.start()

    def submit(self, clip) -> Future:
        """Raises ``queue.Full`` when the backlog bound is hit (overload)
        and ``RuntimeError`` after ``close()`` — a silently-enqueued item
        would never resolve."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        fut = Future()
        try:
            self._q.put_nowait((np.asarray(clip), fut, time.perf_counter()))
        except queue.Full:
            with self._lock:
                self.stats["rejected"] += 1
            raise
        if self._stop.is_set():
            # close() may have drained the queue between our stop-check and
            # the put — nobody will service this item; fail it fast instead
            # of leaving the caller to block its full result timeout
            self._resolve(fut, exc=RuntimeError("MicroBatcher is closed"))
        return fut

    @staticmethod
    def _resolve(fut, value=None, exc=None):
        """set_result/set_exception tolerant of a concurrent caller-side
        cancel — an InvalidStateError escaping the dispatch loop would kill
        the thread and hang every future submit."""
        try:
            if fut.cancelled():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(value)
        except Exception:  # InvalidStateError: lost the race to cancel()
            pass

    def _gather(self):
        """Block for one request, then fill the batch until full or the
        deadline — measured from the first request's SUBMIT time, so a
        request that already aged in the queue behind a slow batch never
        waits a second delay window (whatever is already queued still
        coalesces via the non-blocking drain)."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        items = [first]
        deadline = first[2] + self.max_delay
        while len(items) < self.max_batch:
            remaining = deadline - time.perf_counter()
            try:
                if remaining <= 0:
                    items.append(self._q.get_nowait())
                else:
                    items.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return items

    def _fail(self, items, exc):
        with self._lock:
            self.stats["errors"] += len(items)
        for _, fut, _ in items:
            self._resolve(fut, exc=exc)

    def _run_batch(self, items):
        clips = np.stack([c for c, _, _ in items])
        scores = self._predict(clips)
        if len(scores) < len(items):
            raise ValueError(
                f"predict_fn returned {len(scores)} rows for "
                f"{len(items)} clips")
        now = time.perf_counter()
        with self._lock:
            self.stats["requests"] += len(items)
            self.stats["batches"] += 1
            self.stats["batched_clips"] += len(items)
            for _, _, t_in in items:
                ms = (now - t_in) * 1000.0
                self.stats["latency_ms_sum"] += ms
                self.stats["latency_ms_max"] = max(
                    self.stats["latency_ms_max"], ms)
        for i, (_, fut, _) in enumerate(items):
            self._resolve(fut, value=scores[i])

    def _loop(self):
        while not self._stop.is_set():
            items = self._gather()
            if not items:
                continue
            # EVERYTHING per-batch stays inside the try: an escaped
            # exception (mismatched clip shapes failing np.stack, a bad
            # predict return, ...) must fail THIS batch's futures, never
            # kill the dispatch thread — a dead thread would hang every
            # future submit forever
            try:
                self._run_batch(items)
            except Exception as e:
                self._fail(items, e)

    def snapshot(self):
        with self._lock:
            s = dict(self.stats)
        s["mean_batch"] = (s["batched_clips"] / s["batches"]
                           if s["batches"] else 0.0)
        s["mean_latency_ms"] = (s["latency_ms_sum"] / s["requests"]
                                if s["requests"] else 0.0)
        return s

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
        # fail anything still queued: an abandoned item's caller would
        # otherwise block its full result timeout
        while True:
            try:
                _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            self._resolve(fut, exc=RuntimeError("MicroBatcher closed"))
