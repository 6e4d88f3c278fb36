"""Architecture registry: ``--arch <id>`` resolution.

Only the architectures the port can serve are registered; the other
families of the reference come with later slices (see ROADMAP.md).
"""

from __future__ import annotations

from typing import Dict

from . import falcon_mamba_7b, tinyllama_1_1b
from .base import ModelConfig

_MODULES = (tinyllama_1_1b, falcon_mamba_7b)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ALIASES = {"tinyllama": "tinyllama-1.1b", "falcon-mamba": "falcon-mamba-7b"}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[key]


def list_archs():
    return sorted(REGISTRY)
