"""K1B's share of its roofline over the traced stretch of a train
cell: the least time of the calls the cell's shapes make
(``ops/k1b.py``) over the device time under the operation's ranges."""

from benchmark.roofline import op_share


def read(run):
    return op_share(run, "k1b") if run.kind == "train" else None
