from .base import ModelConfig
from .registry import ALIASES, REGISTRY, get_config, list_archs

__all__ = ["ModelConfig", "REGISTRY", "ALIASES", "get_config", "list_archs"]
