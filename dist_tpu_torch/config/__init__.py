from dist_tpu_torch.config.config import Config, load_config

__all__ = ["Config", "load_config"]
