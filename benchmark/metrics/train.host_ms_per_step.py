"""The host's time inside each call of the train step over the window,
before any synchronisation: what it takes the host to queue a step (the
mean; in a traced run, of the steps outside the profiled stretch)."""

from benchmark.train_cell import host_ms_per_step


def read(run):
    return host_ms_per_step(run) if run.kind == "train" else None
