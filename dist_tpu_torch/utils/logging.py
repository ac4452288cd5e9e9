"""Logging for the port (port of ``dist_tpu/utils/logging.py``): the
root logger set up per task, process 0 only, to stdout and a file under
``OUTPUT_DIR``; one-line JSON stat records. The JAX package writes its
JSON stat lines with ``simplejson`` and ``Decimal``s; the port rounds
floats to 6 decimals and uses the standard ``json`` module."""

import json
import logging
import os
import sys

_FORMAT = "[%(asctime)s][%(levelname)s] %(filename)s: %(lineno)3d: %(message)s"


def _is_master():
    """Process 0 of ``torch.distributed``, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def setup_logging(cfg, log_name="log"):
    """Configure the root logger for one task: process 0 logs to stdout
    and to ``OUTPUT_DIR/<log_name>`` (appended); other processes log
    nothing. Replaces the handlers of an earlier task, closing its file."""
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    if not _is_master():
        root.addHandler(logging.NullHandler())
        return
    formatter = logging.Formatter(_FORMAT, datefmt="%m/%d %H:%M:%S")
    ch = logging.StreamHandler(stream=sys.stdout)
    ch.setFormatter(formatter)
    root.addHandler(ch)
    out_dir = cfg.get("OUTPUT_DIR")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(out_dir, log_name), mode="a")
        fh.setFormatter(formatter)
        root.addHandler(fh)


def get_logger(name):
    return logging.getLogger(name)


def log_json_stats(stats):
    """One ``json_stats: {...}`` line, keys sorted, floats to 6 decimals."""
    stats = {k: round(v, 6) if isinstance(v, float) else v
             for k, v in stats.items()}
    get_logger(__name__).info("json_stats: %s",
                              json.dumps(stats, sort_keys=True))
