from .base import (
    ARCH_ALIASES,
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    config_for_shape,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_ALIASES", "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
    "config_for_shape", "get_config", "get_smoke_config",
]
