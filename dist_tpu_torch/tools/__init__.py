"""Tools of the port, each run as ``python -m dist_tpu_torch.tools.<name>``:
measurement and serving (``microbench``, ``profile_eval``, ``bench``,
``bench_serving``, ``serve``), the Model-Zoo harness
(``reproduce_model_zoo``) and the checkpoint tools (``convert_checkpoint``,
``average_checkpoints``, ``classify``). Importing one runs nothing."""
