from fei_tpu_torch.utils.logging import get_logger, setup_logging
from fei_tpu_torch.utils.config import Config, get_config
from fei_tpu_torch.utils.errors import (
    FeiError,
    ConfigError,
    ProviderError,
    EngineError,
)

__all__ = [
    "get_logger",
    "setup_logging",
    "Config",
    "get_config",
    "FeiError",
    "ConfigError",
    "ProviderError",
    "EngineError",
]
