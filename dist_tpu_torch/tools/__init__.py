"""Measurement and serving tools of the port, each run as
``python -m dist_tpu_torch.tools.<name>``: ``microbench``,
``profile_eval``, ``bench``, ``bench_serving`` and ``serve``. Importing
one runs nothing."""
