from repro_torch.configs.base import (
    BlockDef,
    ModelConfig,
    ShapeConfig,
    SHAPES,
    all_configs,
    get_config,
    register,
    shapes_for,
)

__all__ = [
    "BlockDef",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "all_configs",
    "get_config",
    "register",
    "shapes_for",
]
