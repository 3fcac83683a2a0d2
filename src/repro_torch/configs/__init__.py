"""Architecture registry of the port.  Importing this package registers the
archs whose families the port runs."""
from repro_torch.configs.base import ModelConfig, get_config, register
from repro_torch.configs import recurrentgemma_2b  # noqa: F401

__all__ = ["ModelConfig", "get_config", "register"]
