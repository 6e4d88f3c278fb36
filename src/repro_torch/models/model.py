"""Top-level model API for the dense decode path: embed -> layers -> logits.

The PyTorch counterpart of the reference's ``repro/models/model.py``.
``forward_decode`` walks the layers in a Python loop (the reference scans
them); caches keep the reference's layout, ``{"sub<i>": {"k", "v"}}`` with
tensors of shape ``(num_groups, B, cache_len, K, hd)``, and are updated in
place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig

from . import attention as attn_mod
from .layers import mlp_apply, rms_norm
from .transformer import _dtype, _group_windows, check_family, init_params, layer_params

__all__ = ["init_params", "init_caches", "forward_decode"]


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["table"][tokens.long()]
    # the scale is rounded to the activation dtype first, as in the reference
    return x * torch.sqrt(torch.tensor(cfg.d_model, dtype=x.dtype, device=x.device))


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T
    return x @ params["unembed"]


def init_caches(
    cfg: ModelConfig, batch: int, cache_len: int, device: Optional[Union[str, torch.device]] = None
) -> Dict:
    """Zero decode caches on ``device`` (the card by default)."""
    check_family(cfg)
    dev = resolve_device(device)
    gp = cfg.layer_group
    ng = cfg.num_layers // gp
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    caches = {}
    for i, w in enumerate(_group_windows(cfg)):
        clen = min(cache_len, w) if w else cache_len
        shape = (ng, batch, clen, kv, hd)
        caches[f"sub{i}"] = {
            "k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
        }
    return caches


def _layer_decode(cfg: ModelConfig, p: Dict, x, cache: Dict, pos, window: int):
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    out, _, _ = attn_mod.decode_attention(
        p["attn"], h, cache["k"], cache["v"], pos,
        num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        window=window, softcap=cfg.attn_logit_softcap,
    )
    x = x + out
    if "ffn_norm" in p:
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["ffn_norm"], cfg.rms_eps), cfg.act)
    return x


def forward_decode(
    cfg: ModelConfig,
    params: Dict,
    caches: Dict,
    token: torch.Tensor,  # (B, 1) int
    pos: torch.Tensor,  # (B,) absolute position of `token`
) -> Tuple[torch.Tensor, Dict]:
    """One decode step: returns ``(logits (B, V), caches)``; the caches are
    the same tensors, updated in place."""
    check_family(cfg)
    x = _embed(cfg, params, token)
    gp = cfg.layer_group
    windows = _group_windows(cfg)
    for g in range(cfg.num_layers // gp):
        for i in range(gp):
            cache = {name: t[g] for name, t in caches[f"sub{i}"].items()}
            x = _layer_decode(cfg, layer_params(params["layers"], g * gp + i), x, cache, pos, windows[i])
    return _logits(cfg, params, x)[:, 0], caches
