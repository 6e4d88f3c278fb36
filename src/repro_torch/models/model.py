"""Top-level model API: embed -> layers -> logits, for training, prefill and decode.

The PyTorch counterpart of the reference's ``repro/models/model.py`` for
every family.  ``forward_decode`` walks the layers in a Python loop (the
reference scans them); caches keep the reference's layout, ``{"sub<i>":
{...}}`` with a leading ``num_groups`` axis — ``k`` and ``v``
``(num_groups, B, cache_len, K, hd)`` for attention, ``conv``
``(num_groups, B, k-1, d_inner)`` and ``ssm`` ``(num_groups, B, d_inner,
state)`` float32 for Mamba — and are updated in place.
``forward_train`` and ``forward_prefill`` run the whole sequence through
:func:`~repro_torch.models.transformer.stack_forward` (the Mamba heads on
the fused scan kernels with ``ssm_backend="fused"``).  A VLM batch's
``prefix_emb (B, P, d)`` is projected and put before the text, under the
prefix mask; an audio batch's ``frames (B, S_enc, d)`` go through
:func:`encoder_forward`, whose keys and values every decoder layer's
cross-attention reads.  :func:`abstract_caches` gives the caches as meta
tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import AUDIO, HYBRID, SSM, VLM, ModelConfig
from repro_torch.parallel.sharding import constrain

from . import attention as attn_mod
from . import ssm as ssm_mod
from . import moe as moe_mod
from .layers import mlp_apply, profiler_range, rms_norm, sinusoidal_positions
from .transformer import _dtype, _group_windows, abstract_params, init_params, layer_params, stack_forward

__all__ = ["init_params", "abstract_params", "init_caches", "abstract_caches", "forward_train", "forward_prefill",
           "forward_decode", "encoder_forward"]


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"]["table"][tokens.long()]
    # the scale is rounded to the activation dtype first, as in the reference
    return constrain(x * torch.sqrt(torch.tensor(cfg.d_model, dtype=x.dtype, device=x.device)),
                     "act_batch", "act_seq", "act_embed")


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = x @ params["embed"]["table"].T if cfg.tie_embeddings else x @ params["unembed"]
    return constrain(logits, "act_batch", "act_seq", "act_vocab")


def init_caches(
    cfg: ModelConfig, batch: int, cache_len: int, device: Optional[Union[str, torch.device]] = None
) -> Dict:
    """Zero decode caches on ``device`` (the card by default)."""
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


def abstract_caches(cfg: ModelConfig, batch: int, cache_len: int) -> Dict:
    """:func:`init_caches`' tree as meta tensors: shapes and dtypes, nothing allocated."""
    return init_caches(cfg, batch, cache_len, device="meta")


def encoder_forward(cfg: ModelConfig, params: Dict, frames: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The audio encoder over precomputed frame embeddings (the stub
    frontend): ``frames (B, S_enc, d)``, in the model's dtype, to every
    decoder layer's cross keys and values ``(ek, ev)``, each ``(L, B,
    S_enc, K, hd)``.

    ``frames @ frame_proj`` plus the sinusoidal table, the encoder's
    layers with full attention (the config cut to ``encoder_layers``
    layers, with no windows and no experts), its final norm, then each
    decoder layer's cross ``wk`` and ``wv`` of the output, in one stacked
    product each (the reference maps one product over the layers).
    """
    enc = params["encoder"]
    with profiler_range("model.encoder"):
        frames = torch.as_tensor(frames, device=enc["frame_proj"].device)
        b, s, _ = frames.shape
        x = frames @ enc["frame_proj"]
        x = x + sinusoidal_positions(s, cfg.d_model, device=x.device).to(x.dtype)[None]
        enc_cfg = dataclasses.replace(cfg, num_layers=cfg.encoder_layers, global_every=0, sliding_window=0,
                                      num_experts=0, experts_per_token=0)
        x, _ = stack_forward(enc_cfg, enc["layers"], x, torch.arange(s, device=x.device), kind="full")
        x = rms_norm(x, enc["final_norm"], cfg.rms_eps)
        shape = (-1, b, s, cfg.num_kv_heads, cfg.resolved_head_dim)
        cross = params["layers"]["cross"]
        return (torch.einsum("bsd,ldn->lbsn", x, cross["wk"]).reshape(shape),
                torch.einsum("bsd,ldn->lbsn", x, cross["wv"]).reshape(shape))


def _prepare_inputs(cfg: ModelConfig, params: Dict, batch: Dict):
    """Embed the inputs: ``(x, positions, kind, prefix_len, enc_kv)``.

    Audio: the tokens' embeddings (scaled by sqrt(d)) plus the sinusoidal
    table, and the encoder's ``enc_kv`` of ``batch["frames"]``.  VLM with
    ``batch["prefix_emb"] (B, P, d)``: ``prefix_emb @ prefix_proj`` (not
    scaled) before the scaled token embeddings, the prefix mask and
    ``prefix_len = P``; positions count the prefix.  Otherwise (a VLM
    batch without a prefix too) the tokens alone, causal."""
    dev = params["embed"]["table"].device
    x = _embed(cfg, params, torch.as_tensor(batch["tokens"], device=dev))
    kind, prefix_len, enc_kv = "causal", 0, None
    if cfg.family == AUDIO:
        enc_kv = encoder_forward(cfg, params, batch["frames"])
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, device=dev).to(x.dtype)[None]
    elif cfg.family == VLM and "prefix_emb" in batch:
        pre = (torch.as_tensor(batch["prefix_emb"], device=dev) @ params["prefix_proj"]).to(_dtype(cfg))
        x = torch.cat([pre, x], dim=1)
        kind, prefix_len = "prefix", pre.shape[1]
    return x, torch.arange(x.shape[1], device=dev), kind, prefix_len, enc_kv


def forward_train(cfg: ModelConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Logits ``(B, S, V)`` aligned with ``batch["labels"]``, from the
    cache-free stack (rematerialised per layer group with ``cfg.remat``);
    a VLM prefix's positions are dropped before the logits."""
    x, positions, kind, prefix_len, enc_kv = _prepare_inputs(cfg, params, batch)
    x, _ = stack_forward(cfg, params["layers"], x, positions, kind=kind, prefix_len=prefix_len, enc_kv_layers=enc_kv)
    return _logits(cfg, params, x[:, prefix_len:])


def forward_prefill(cfg: ModelConfig, params: Dict, batch: Dict, cache_len: int = 0):
    """Run the prompt ``batch["tokens"] (B, S)`` (with its ``prefix_emb``
    or ``frames``): ``(last-position logits (B, V), caches, enc_kv)``, the
    caches in :func:`init_caches`' layout for ``cache_len`` (the
    sequence's length when 0), ready for :func:`forward_decode` at the
    next position (a VLM prefix of P counts: ``P + S``); ``enc_kv`` is
    :func:`encoder_forward`'s for audio, else None.

    A global attention cache of exactly ``S`` clamps decode's first write
    onto slot ``S - 1``, as in the reference: a caller that decodes on
    passes a ``cache_len`` past the prompt.
    """
    x, positions, kind, prefix_len, enc_kv = _prepare_inputs(cfg, params, batch)
    x, caches = stack_forward(cfg, params["layers"], x, positions, kind=kind, prefix_len=prefix_len,
                              enc_kv_layers=enc_kv, collect_caches=True, cache_len=cache_len or x.shape[1])
    logits = _logits(cfg, params, x[:, -1:])[:, 0]
    return logits, caches, enc_kv


def _layer_decode(cfg: ModelConfig, p: Dict, x, cache: Dict, pos, window: int, enc_kv=None):
    """One layer, one token; the branches are summed into ``mix`` before
    ``x + mix``, as in :func:`~repro_torch.models.transformer._layer_fwd`,
    then a decoder layer of an encoder-decoder model attends over its
    ``enc_kv`` (skipped when it is None, as in the reference)."""
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
    if "cross" in p and enc_kv is not None:
        hc = rms_norm(x, p["cross_norm"], cfg.rms_eps)
        x = x + attn_mod.cross_decode_attention(p["cross"], hc, enc_kv[0], enc_kv[1], num_heads=cfg.num_heads,
                                                num_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim)
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
    enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (L, B, S_enc, K, hd) x 2 for enc-dec
) -> Tuple[torch.Tensor, Dict]:
    """One decode step: returns ``(logits (B, V), caches)``; the caches are
    the same tensors, updated in place.  An audio token gets the
    sinusoidal embedding of its position; its cross-attention reads
    ``enc_kv``, and is skipped without it, as in the reference."""
    x = _embed(cfg, params, token)
    if cfg.family == AUDIO:
        table = sinusoidal_positions(caches["sub0"]["k"].shape[2] + 1, cfg.d_model, device=x.device)
        x = x + table[pos.long()][:, None].to(x.dtype)
    gp = cfg.layer_group
    windows = _group_windows(cfg)
    for g in range(cfg.num_layers // gp):
        for i in range(gp):
            layer = g * gp + i
            cache = {name: t[g] for name, t in caches[f"sub{i}"].items()}
            ekv = (enc_kv[0][layer], enc_kv[1][layer]) if enc_kv is not None else None
            x = _layer_decode(cfg, layer_params(params["layers"], layer), x, cache, pos, windows[i], ekv)
    return _logits(cfg, params, x)[:, 0], caches
