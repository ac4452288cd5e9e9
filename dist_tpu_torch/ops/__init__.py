"""The port's kernels and their plain versions. Importing the package
registers the ``torch.library`` operators of the eval path's kernels,
``dist_tpu_torch::attention_qkv`` (K1) and
``dist_tpu_torch::temporal_net_fwd`` (K2), which a program saved by
``serving/export.py`` calls by name."""

from dist_tpu_torch.ops import attention, temporal_net  # noqa: F401
