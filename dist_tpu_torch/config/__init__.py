from dist_tpu_torch.config.config import Config, load_config, load_from_args

__all__ = ["Config", "load_config", "load_from_args"]
