from repro_torch.common.config import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    RWKVConfig,
    SSMConfig,
    ServeConfig,
    TrainConfig,
)

__all__ = [
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "MoEConfig",
    "RWKVConfig",
    "SSMConfig",
    "ServeConfig",
    "TrainConfig",
]
