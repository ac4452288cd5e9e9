"""The benchmark of ``dist_tpu_torch`` on NVIDIA H100s.

``BENCHMARK.json`` at the checkout's root names the cells; one run of one
cell is ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` from the root. What belongs to one cell, mix, metric
or operation sits in a file of its own, found by its name:

- ``configs/<config>.json``: the program's YAML and overrides, the batch,
  the source, what was assumed, the keys the program's configuration must
  hold, and the numbers the reference computes with;
- ``traffic/<mix>.json``: the mix's parameters (its ``kind``, train or
  serve, picks the code that runs it: ``train_cell.py`` or
  ``serve_cell.py``);
- ``limits/<cell>.json``: the limits of ``correct``, with the readings
  each was set from (``calibrate.py``);
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``;
- ``ops/<op>.py``: an operation's ranges in the trace, its calls in a
  cell, and its bytes and operations a call.

The yardstick stays here: the reference (``reference/``), the weights
and inputs from the seed (``weights.py``), the operation counts
(``flops.py``, ``ops/``), the peaks (``roofline.py``), the trace's
reduction (``trace.py``) and the comparison (``checks.py``). It imports
nothing of JAX or the JAX package. Tests: ``python -m pytest
benchmark/tests`` (on the CPU at a tiny size; the ``cuda``-marked ones
run on a card)."""
