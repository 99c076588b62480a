"""Model configurations: the port's copy of ``repro.configs``."""
from repro_torch.configs.base import (
    REGISTRY,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    get_config,
    list_archs,
    register,
    shape_applicable,
)

__all__ = [
    "REGISTRY",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "list_archs",
    "register",
    "shape_applicable",
]
