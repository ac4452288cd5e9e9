"""Serving: the inference engine, cross-request micro-batching, the HTTP
front end (``server.py``) and model export (``export.py``).

``InferenceEngine`` and ``MicroBatcher`` are imported on first use, so
that the export loader (``serving/export.py::load_predictor``) runs
without the model code."""

__all__ = ["InferenceEngine", "MicroBatcher"]


def __getattr__(name):
    if name == "InferenceEngine":
        from dist_tpu_torch.serving.engine import InferenceEngine
        return InferenceEngine
    if name == "MicroBatcher":
        from dist_tpu_torch.serving.batcher import MicroBatcher
        return MicroBatcher
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
