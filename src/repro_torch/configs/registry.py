"""Architecture registry: ``--arch <id>`` resolution.

Every architecture of the reference is registered, in every family:
dense, SSM, hybrid, MoE, VLM and audio.
"""

from __future__ import annotations

from typing import Dict

from . import (
    falcon_mamba_7b,
    gemma3_12b,
    hymba_1_5b,
    moonshot_v1_16b_a3b,
    nemotron_4_340b,
    paligemma_3b,
    phi35_moe_42b_a6_6b,
    tinyllama_1_1b,
    whisper_large_v3,
    yi_6b,
)
from .base import ModelConfig

_MODULES = (hymba_1_5b, moonshot_v1_16b_a3b, phi35_moe_42b_a6_6b, tinyllama_1_1b, yi_6b, gemma3_12b, nemotron_4_340b,
            falcon_mamba_7b, paligemma_3b, whisper_large_v3)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

ALIASES = {
    "hymba": "hymba-1.5b",
    "moonshot": "moonshot-v1-16b-a3b",
    "phi35-moe": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "tinyllama": "tinyllama-1.1b",
    "yi": "yi-6b",
    "gemma3": "gemma3-12b",
    "nemotron": "nemotron-4-340b",
    "falcon-mamba": "falcon-mamba-7b",
    "paligemma": "paligemma-3b",
    "whisper": "whisper-large-v3",
}


def get_config(name: str) -> ModelConfig:
    key = ALIASES.get(name, name)
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[key]


def list_archs():
    return sorted(REGISTRY)
