"""K2's share of its roofline over the traced stretch of a serve cell:
the least time of the calls the cell's shapes make (``ops/k2.py``)
over the device time under the operation's ranges."""

from benchmark.roofline import op_share


def read(run):
    return op_share(run, "k2") if run.kind == "serve" else None
