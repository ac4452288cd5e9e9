"""Data parallelism over ``torch.distributed``: the data axis, the host
collectives and the launcher (port of ``dist_tpu/parallel/``)."""
