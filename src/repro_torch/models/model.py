"""Top-level model API: embed -> layers -> logits, for training, prefill and decode.

The PyTorch counterpart of the reference's ``repro/models/model.py`` for
the dense, SSM, hybrid and MoE families.  ``forward_decode`` walks the layers in a
Python loop (the reference scans them); caches keep the reference's
layout, ``{"sub<i>": {...}}`` with a leading ``num_groups`` axis — ``k``
and ``v`` ``(num_groups, B, cache_len, K, hd)`` for attention, ``conv``
``(num_groups, B, k-1, d_inner)`` and ``ssm`` ``(num_groups, B, d_inner,
state)`` float32 for Mamba — and are updated in place.
``forward_train`` and ``forward_prefill`` run the whole sequence through
:func:`~repro_torch.models.transformer.stack_forward` (the Mamba heads on
the fused scan kernels with ``ssm_backend="fused"``).  The VLM prefix and
the audio encoder come with a later slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import HYBRID, SSM, ModelConfig

from . import attention as attn_mod
from . import ssm as ssm_mod
from . import moe as moe_mod
from .layers import mlp_apply, rms_norm
from .transformer import _dtype, _group_windows, check_family, init_params, layer_params, stack_forward

__all__ = ["init_params", "init_caches", "forward_train", "forward_prefill", "forward_decode"]


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
    dtype = _dtype(cfg)
    ng = cfg.num_layers // cfg.layer_group
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    caches = {}
    for i, w in enumerate(_group_windows(cfg)):
        sub = {}
        if cfg.family != SSM:
            clen = min(cache_len, w) if w else cache_len
            sub["k"] = torch.zeros((ng, batch, clen, kv, hd), dtype=dtype, device=dev)
            sub["v"] = torch.zeros((ng, batch, clen, kv, hd), dtype=dtype, device=dev)
        if cfg.family in (SSM, HYBRID):
            sub["conv"] = torch.zeros((ng, batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype, device=dev)
            sub["ssm"] = torch.zeros((ng, batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=dev)
        caches[f"sub{i}"] = sub
    return caches


def _prepare_inputs(cfg: ModelConfig, params: Dict, batch: Dict):
    """Embed the tokens: ``(x, positions, kind, prefix_len)``, the token
    path of the reference (the VLM prefix and the audio encoder raise in
    :func:`~repro_torch.models.transformer.check_family`)."""
    check_family(cfg)
    x = _embed(cfg, params, torch.as_tensor(batch["tokens"], device=params["embed"]["table"].device))
    return x, torch.arange(x.shape[1], device=x.device), "causal", 0


def forward_train(cfg: ModelConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Logits ``(B, S, V)`` aligned with ``batch["labels"]``, from the
    cache-free stack (rematerialised per layer group with ``cfg.remat``)."""
    x, positions, kind, prefix_len = _prepare_inputs(cfg, params, batch)
    x, _ = stack_forward(cfg, params["layers"], x, positions, kind=kind, prefix_len=prefix_len)
    return _logits(cfg, params, x)


def forward_prefill(cfg: ModelConfig, params: Dict, batch: Dict, cache_len: int = 0):
    """Run the prompt ``batch["tokens"] (B, S)``: ``(last-position logits
    (B, V), caches, enc_kv)``, the caches in :func:`init_caches`' layout
    for ``cache_len`` (``S`` when 0), ready for :func:`forward_decode` at
    position ``S``; ``enc_kv`` is None.

    A global attention cache of exactly ``S`` clamps decode's first write
    onto slot ``S - 1``, as in the reference: a caller that decodes on
    passes a ``cache_len`` past the prompt.
    """
    x, positions, kind, prefix_len = _prepare_inputs(cfg, params, batch)
    x, caches = stack_forward(cfg, params["layers"], x, positions, kind=kind, prefix_len=prefix_len,
                              collect_caches=True, cache_len=cache_len or x.shape[1])
    logits = _logits(cfg, params, x[:, -1:])[:, 0]
    return logits, caches, None


def _layer_decode(cfg: ModelConfig, p: Dict, x, cache: Dict, pos, window: int):
    """One layer, one token; the branches are summed into ``mix`` before
    ``x + mix``, as in :func:`~repro_torch.models.transformer._layer_fwd`."""
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    mix = None
    if "attn" in p:
        mix, _, _ = attn_mod.decode_attention(
            p["attn"], h, cache["k"], cache["v"], pos,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=window, softcap=cfg.attn_logit_softcap,
        )
    if "mamba" in p:
        y, conv, ssm = ssm_mod.mamba_decode(p["mamba"], h, cache["conv"], cache["ssm"], cfg)
        cache["conv"].copy_(conv)
        cache["ssm"].copy_(ssm)
        mix = y if mix is None else mix + y
    x = x + mix
    if "ffn_norm" in p:
        hf = rms_norm(x, p["ffn_norm"], cfg.rms_eps)
        x = x + (moe_mod.moe_apply(p["moe"], hf, cfg) if "moe" in p else mlp_apply(p["mlp"], hf, cfg.act))
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
