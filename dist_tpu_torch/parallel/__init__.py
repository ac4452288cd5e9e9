"""The mesh over ``torch.distributed`` (data, pipe and model axes, FSDP),
the host collectives, the launcher and one process over its local
devices (port of ``dist_tpu/parallel/``)."""
