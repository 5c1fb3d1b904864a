"""Architecture configs: a copy of the JAX package's ``configs/`` (plain
frozen dataclasses), kept here so that the port imports nothing of it."""
from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    EncoderConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    VisionConfig,
    get_config,
    get_smoke_config,
    registry,
)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "EncoderConfig", "InputShape", "ModelConfig",
    "MoEConfig", "SSMConfig", "VisionConfig", "get_config", "get_smoke_config",
    "registry",
]
