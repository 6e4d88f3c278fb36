"""Serve-step builders, the counterparts of the reference's ``repro/train/steps.py``.

``make_prefill_step(cfg)`` and ``make_decode_step(cfg)`` return the
functions that the reference's dry run lowers for its ``prefill`` and
``decode`` shapes.  Both cast the parameters to the compute dtype first,
with the reference's rule (:func:`_cast`).  A leaf already in that dtype
passes through uncopied, so a caller that steps many times casts its
parameters once with :func:`_cast` (as the serving engine does) and each
step copies nothing.  The training step, its loss and its optimizer come
with the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import forward_decode, forward_prefill
from repro_torch.models.transformer import _dtype


def _cast(params: Dict, dtype: torch.dtype) -> Dict:
    """Float32 leaves of rank > 1 to ``dtype``; the others as they are.

    This is the reference's rule.  Once the layers are stacked, the
    Mamba blocks' ``A_log`` and ``D`` and the norm scales have rank >= 2,
    so they reach the model in the compute dtype too (ROADMAP.md, R6).
    """
    return {k: _cast(v, dtype) if isinstance(v, dict) else
            (v.to(dtype) if v.dtype == torch.float32 and v.ndim > 1 else v)
            for k, v in params.items()}


def make_prefill_step(cfg: ModelConfig):
    compute_dtype = _dtype(cfg)

    def prefill_step(params: Dict, batch: Dict):
        """``(last-position logits (B, V), caches)`` for ``batch["tokens"]``."""
        logits, caches, _ = forward_prefill(cfg, _cast(params, compute_dtype), batch)
        return logits, caches

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    compute_dtype = _dtype(cfg)

    def decode_step(params: Dict, caches: Dict, token: torch.Tensor, pos: torch.Tensor):
        """``(logits (B, V), caches)``; the caches are updated in place."""
        return forward_decode(cfg, _cast(params, compute_dtype), caches, token, pos)

    return decode_step
