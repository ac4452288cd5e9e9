"""The yardstick's peaks and the least time a piece of work can take on
one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit):
989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in fp32 on the CUDA
cores, 3.35 TB/s of HBM3."""

from benchmark import spec

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


class ShareAboveFull(ValueError):
    """A share of a roofline or of a peak read above 100 %: the work is
    counted too high or the time leaves part of it out."""


def bound_s(nbytes, flops, dtype="bfloat16"):
    """The larger of bytes over the memory rate and operations over the
    peak rate of their type, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def share(least_s, took_s, what):
    """100 * least / took; raises above 100 %."""
    pct = 100.0 * least_s / took_s
    if pct > 100.0:
        raise ShareAboveFull(f"{what}: {pct:.4f} % of its bound "
                             f"(least {least_s} s, took {took_s} s)")
    return pct


def op_share(run, op_name):
    """An operation's roofline share over the traced stretch: the least
    time of its calls there, counted from the cell's shapes by
    ``ops/<op>.py``, over the device time of the kernels launched under
    its ranges. None where the stretch holds none of its calls or no
    device time under its ranges."""
    if run.trace is None:
        return None
    op = spec.operation(op_name, run.root)
    calls = op.calls(run)
    least = sum(n * bound_s(*op.work(shape)) for n, shape in calls)
    took = sum(run.trace.range_s.get(r, 0.0) for r in op.RANGES)
    if not calls or least <= 0 or took <= 0:
        return None
    return share(least, took, f"{op_name} in {run.cell['name']}")


def mfu(flops, seconds, chips, what):
    """The share of the chips' bf16 peak that ``flops`` in ``seconds``
    is, in %."""
    return share(flops / PEAK_FLOPS["bfloat16"], seconds * chips, what)
