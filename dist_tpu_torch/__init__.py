"""PyTorch/CUDA port of ``dist_tpu`` for NVIDIA Hopper.

The JAX package ``dist_tpu`` stays the reference; this package imports
nothing of it. Hand-written CUDA kernels live in ``csrc/`` and are built
with ``nvcc`` at first use (``ops/_build.py``).
"""
