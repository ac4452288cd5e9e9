"""The share of the traced stretch of a serve cell in which no operation
ran on the device, from that stretch's own timeline."""


def read(run):
    if run.kind != "serve" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
