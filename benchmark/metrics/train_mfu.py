"""The training window's share of the chips' bf16 peak: the model's
operations of the window's steps (``flops.py``) over the window's
seconds times 989 TFLOP/s times the chips. In a traced run the profiled
stretch's steps and seconds are left out (the profiler slows the host)."""

from benchmark.roofline import mfu
from benchmark.train_cell import step_flops


def read(run):
    w = run.window
    if run.kind != "train" or not w.get("steps"):
        return None
    steps = w.get("untraced_steps", w["steps"])
    seconds = w.get("untraced_s", w["seconds"])
    return mfu(steps * step_flops(run), seconds, run.chips, "train_mfu")
