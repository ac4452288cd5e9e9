"""Logging for the port (``get_logger`` of ``dist_tpu/utils/logging.py``).

The JAX package's JSON stat lines use ``simplejson``; the port writes
such lines with the standard ``json`` module when a later slice needs
them.
"""

import logging


def get_logger(name):
    return logging.getLogger(name)
