"""Clips in a device batch over the window, from the batcher's own
counts (``MicroBatcher.stats``: batched clips over batches)."""


def read(run):
    w = run.window
    if run.kind != "serve" or not w.get("batches"):
        return None
    return w["batched"] / w["batches"]
