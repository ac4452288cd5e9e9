"""Serving: the inference engine, cross-request micro-batching and the
HTTP front end (``server.py``)."""

from dist_tpu_torch.serving.batcher import MicroBatcher
from dist_tpu_torch.serving.engine import InferenceEngine

__all__ = ["InferenceEngine", "MicroBatcher"]
