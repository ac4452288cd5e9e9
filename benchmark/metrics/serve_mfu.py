"""The serving window's share of the chips' bf16 peak: the model's
operations of the requests answered (``flops.py``) over the window's
seconds times 989 TFLOP/s times the chips."""

from benchmark.roofline import mfu
from benchmark.serve_cell import serve_flops


def read(run):
    if run.kind != "serve" or not run.window.get("latency_s"):
        return None
    return mfu(serve_flops(run), run.window["seconds"], run.chips, "serve_mfu")
