"""SSL pretraining's view generators (port of ``dist_tpu/ssl``)."""
