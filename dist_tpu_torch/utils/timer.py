"""Pausable wall-clock timer (port of ``dist_tpu/utils/timer.py``)."""

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._total = 0.0
        self._start = None
        self._paused = True

    def tic(self):
        self._start = time.perf_counter()
        self._paused = False

    def toc(self):
        if not self._paused and self._start is not None:
            self._total += time.perf_counter() - self._start
            self._paused = True

    def seconds(self):
        total = self._total
        if not self._paused and self._start is not None:
            total += time.perf_counter() - self._start
        return total
