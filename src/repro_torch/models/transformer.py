"""Dense decoder stack: parameter init and the per-layer layout.

The PyTorch counterpart of the reference's ``repro/models/transformer.py``
for the dense family.  Parameters keep the reference's layout so that
weights convert one to one (:mod:`repro_torch.convert`): every layer
parameter is stacked on a leading ``num_layers`` axis, and layers are
grouped in homogeneous groups of ``cfg.layer_group``.  Other families
(MoE, SSM, hybrid, VLM, audio) come with later slices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import DENSE, ModelConfig

from .layers import dense_init, mlp_init

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def check_family(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not run yet."""
    if cfg.family != DENSE or cfg.num_experts or cfg.is_encoder_decoder or cfg.num_prefix_tokens:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is ported in a later slice, see ROADMAP.md"
        )


def _attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, lead) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, lead + (d, h * hd), d, dtype),
        "wk": dense_init(gen, lead + (d, kv * hd), d, dtype),
        "wv": dense_init(gen, lead + (d, kv * hd), d, dtype),
        "wo": dense_init(gen, lead + (h * hd, d), h * hd, dtype),
    }


def _layers_init(gen: torch.Generator, cfg: ModelConfig, dtype) -> Dict:
    """All layers' parameters, stacked on a leading ``num_layers`` axis."""
    lead = (cfg.num_layers,)
    norm_shape = lead + (cfg.d_model,)
    p: Dict[str, Any] = {
        "attn_norm": torch.zeros(norm_shape, dtype=torch.float32, device=gen.device),
        "attn": _attn_init(gen, cfg, dtype, lead),
    }
    if cfg.d_ff:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype, lead)
        p["ffn_norm"] = torch.zeros(norm_shape, dtype=torch.float32, device=gen.device)
    return p


def init_params(
    cfg: ModelConfig, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> Dict:
    """Random parameters from ``seed``, on ``device`` (the card by default).

    Weights are drawn on an explicit ``torch.Generator`` in float32 and
    stored in ``cfg.dtype``; norm scales are float32 zeros, as in the
    reference.  The same seed gives the same weights on the same device;
    the numbers differ from the reference's (another generator), so tests
    hand both packages one set of weights through :mod:`repro_torch.convert`.
    """
    check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = _dtype(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": {"table": dense_init(gen, (cfg.vocab_size, d), d, dtype)},
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=dev),
        "layers": _layers_init(gen, cfg, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (d, cfg.vocab_size), d, dtype)
    return params


def _group_windows(cfg: ModelConfig):
    """Per-sublayer sliding window (0 = global) inside one layer group."""
    gp = cfg.layer_group
    if gp == 1:
        return (cfg.sliding_window,) if cfg.sliding_window and not cfg.global_every else (0,)
    return tuple(cfg.sliding_window if i < gp - 1 else 0 for i in range(gp))


def layer_params(layers: Dict, index: int) -> Dict:
    """One layer's parameters: views into the stacked tensors, no copies."""
    return {k: layer_params(v, index) if isinstance(v, dict) else v[index] for k, v in layers.items()}
