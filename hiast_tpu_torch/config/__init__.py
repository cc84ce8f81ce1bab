from hiast_tpu_torch.config.node import ConfigNode
from hiast_tpu_torch.config.schema import default_config
from hiast_tpu_torch.config.loader import load_config, apply_cli_overrides

__all__ = ["ConfigNode", "default_config", "load_config", "apply_cli_overrides"]
