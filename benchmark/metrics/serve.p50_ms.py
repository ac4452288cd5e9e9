"""The median latency of the window's requests, each from when it was
due to when its score row was ready; in a traced run, of the requests due
before the profiled stretch began (the profiler slows the host)."""

from benchmark.serve_cell import percentile_ms


def read(run):
    if run.kind != "serve":
        return None
    return percentile_ms(run, 50, run.window.get("stretch_begin"))
