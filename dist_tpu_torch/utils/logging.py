"""Logging for the port (``get_logger`` and ``log_json_stats`` of
``dist_tpu/utils/logging.py``). The JAX package writes its JSON stat lines
with ``simplejson`` and ``Decimal``s; the port rounds floats to 6 decimals
and uses the standard ``json`` module."""

import json
import logging


def get_logger(name):
    return logging.getLogger(name)


def log_json_stats(stats):
    """One ``json_stats: {...}`` line, keys sorted, floats to 6 decimals."""
    stats = {k: round(v, 6) if isinstance(v, float) else v
             for k, v in stats.items()}
    get_logger(__name__).info("json_stats: %s",
                              json.dumps(stats, sort_keys=True))
