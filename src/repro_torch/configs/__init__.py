from .base import SHAPES, SHAPES_BY_NAME, ModelConfig, ShapeConfig, TrainConfig, shape_applicable
from .registry import ALIASES, REGISTRY, get_config, list_archs

__all__ = ["ModelConfig", "REGISTRY", "ALIASES", "SHAPES", "SHAPES_BY_NAME", "ShapeConfig", "TrainConfig",
           "get_config", "list_archs", "shape_applicable"]
