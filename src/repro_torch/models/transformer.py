"""Decoder stacks: parameter init, the per-layer layout, the prefill and training stack.

The PyTorch counterpart of the reference's ``repro/models/transformer.py``
for every family: dense, SSM, hybrid, MoE, VLM and audio.  Parameters keep
the reference's layout so that weights convert one to one
(:mod:`repro_torch.convert`): every layer parameter is stacked on a
leading ``num_layers`` axis, and layers are grouped in homogeneous groups
of ``cfg.layer_group`` (gemma3 6: 5 sliding-window layers and 1 global,
hymba 8: 7 and 1, the others 1).  An encoder-decoder config's decoder
layers also hold ``cross`` and ``cross_norm``, and its ``encoder`` holds
layers of the same dims; a VLM config holds ``prefix_proj``.  The stack
(:func:`stack_forward`) runs the layers with the decode caches for
prefill, or without them for training (each layer group rematerialised
in the backward per ``cfg.remat`` and ``cfg.remat_policy``).  A MoE
layer's feed-forward is :func:`~repro_torch.models.moe.moe_apply`.
:func:`abstract_params` gives the same tree as meta tensors.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from repro_torch._device import resolve_device
from repro_torch.configs.base import HYBRID, SSM, ModelConfig

from . import attention as attn_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import META, dense_init, mlp_apply, mlp_init, profiler_range, rms_norm

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _attn_init(gen: torch.Generator, cfg: ModelConfig, dtype, lead) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": dense_init(gen, lead + (d, h * hd), d, dtype),
        "wk": dense_init(gen, lead + (d, kv * hd), d, dtype),
        "wv": dense_init(gen, lead + (d, kv * hd), d, dtype),
        "wo": dense_init(gen, lead + (h * hd, d), h * hd, dtype),
    }


def _layers_init(gen: torch.Generator, cfg: ModelConfig, dtype, num_layers: int, cross: bool) -> Dict:
    """``num_layers`` layers' parameters, stacked on a leading axis; with
    ``cross`` each also has its cross-attention and its norm."""
    lead = (num_layers,)
    norm_shape = lead + (cfg.d_model,)
    p: Dict[str, Any] = {"attn_norm": torch.zeros(norm_shape, dtype=torch.float32, device=gen.device)}
    if cfg.family != SSM:
        p["attn"] = _attn_init(gen, cfg, dtype, lead)
    if cfg.family in (SSM, HYBRID):
        p["mamba"] = ssm_mod.mamba_init(gen, cfg, dtype, lead)
    if cross:
        p["cross"] = _attn_init(gen, cfg, dtype, lead)
        p["cross_norm"] = torch.zeros(norm_shape, dtype=torch.float32, device=gen.device)
    if cfg.num_experts:
        p["moe"] = moe_mod.moe_init(gen, cfg, dtype, lead)
        p["ffn_norm"] = torch.zeros(norm_shape, dtype=torch.float32, device=gen.device)
    elif cfg.d_ff:
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
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return _params_init(gen, cfg)


def abstract_params(cfg: ModelConfig) -> Dict:
    """:func:`init_params`' tree as meta tensors: the reference's shapes
    and dtypes, nothing allocated or drawn (the dry run's parameters)."""
    return _params_init(META, cfg)


def _params_init(gen, cfg: ModelConfig) -> Dict:
    dtype = _dtype(cfg)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": {"table": dense_init(gen, (cfg.vocab_size, d), d, dtype)},
        "final_norm": torch.zeros((d,), dtype=torch.float32, device=gen.device),
        "layers": _layers_init(gen, cfg, dtype, cfg.num_layers, cfg.is_encoder_decoder),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, (d, cfg.vocab_size), d, dtype)
    if cfg.num_prefix_tokens:
        params["prefix_proj"] = dense_init(gen, (d, d), d, dtype)
    if cfg.is_encoder_decoder:
        params["encoder"] = {  # the encoder's layers have the decoder's dims
            "layers": _layers_init(gen, cfg, dtype, cfg.encoder_layers, False),
            "final_norm": torch.zeros((d,), dtype=torch.float32, device=gen.device),
            "frame_proj": dense_init(gen, (d, d), d, dtype),
        }
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


def unstack_layers(layers: Dict, n: int) -> List[Dict]:
    """All ``n`` layers' parameters, views into the stacked tensors.

    One ``torch.unbind`` per stacked tensor, so that the backward stacks
    the layers' gradients once; indexing each layer apart would give every
    layer a zero gradient the size of the whole stack to add up.
    """
    per_leaf = {k: unstack_layers(v, n) if isinstance(v, dict) else torch.unbind(v) for k, v in layers.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# layer forward (train / prefill)
# ---------------------------------------------------------------------------


def _layer_fwd(
    cfg: ModelConfig,
    p: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    window: int,
    kind: str,
    prefix_len: int,
    enc_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    collect_cache: bool = False,
    cache_len: int = 0,
):
    """One layer over a whole sequence: ``(x', cache)``.

    The attention and Mamba branches read the same normed input and are
    summed into ``mix`` before ``x + mix``, as in the reference (with two
    branches in bfloat16, ``(x + attn) + mamba`` would round otherwise).
    With ``collect_cache`` the cache is what decoding goes on from: ``k``
    and ``v`` ``(B, clen, K, hd)``, ``clen = min(cache_len, window)`` on a
    sliding-window layer (a ring: a prompt longer than the window wraps
    onto slots ``position % clen``), and the Mamba ``conv`` and ``ssm``
    states.  Without it the cache is empty.  A decoder layer of an
    encoder-decoder model attends over ``enc_kv``, the encoder output's
    keys and values for this layer, after ``x + mix`` and before its MLP.
    """
    cache: Dict[str, torch.Tensor] = {}
    h = rms_norm(x, p["attn_norm"], cfg.rms_eps)
    mix = None
    if "attn" in p:
        mix, k, v = attn_mod.self_attention(
            p["attn"], h,
            num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
            rope_theta=cfg.rope_theta, positions=positions, kind=kind, window=window,
            prefix_len=prefix_len, chunk=cfg.attn_chunk, softcap=cfg.attn_logit_softcap,
            force_blockwise=cfg.train_attn_blockwise and x.shape[1] > 1024,
        )
        if collect_cache:
            cache["k"], cache["v"] = _ring(k, positions, window, cache_len), _ring(v, positions, window, cache_len)
        del k, v
    if "mamba" in p:
        if collect_cache:
            y, cache["conv"], cache["ssm"] = _mamba_with_state(p["mamba"], h, cfg)
        else:
            y = ssm_mod.mamba_forward(p["mamba"], h, cfg)
        mix = y if mix is None else mix + y
    x = x + mix
    if "cross" in p and enc_kv is not None:
        with profiler_range("model.cross"):
            hc = rms_norm(x, p["cross_norm"], cfg.rms_eps)
            x = x + attn_mod.attention(p["cross"], hc, num_heads=cfg.num_heads, num_kv=cfg.num_kv_heads,
                                       head_dim=cfg.resolved_head_dim, rope_theta=0.0, positions=positions,
                                       kv=enc_kv)
    if "ffn_norm" in p:
        hf = rms_norm(x, p["ffn_norm"], cfg.rms_eps)
        x = x + (moe_mod.moe_apply(p["moe"], hf, cfg) if "moe" in p else mlp_apply(p["mlp"], hf, cfg.act))
    return x, cache


def _ring(t: torch.Tensor, positions: torch.Tensor, window: int, cache_len: int) -> torch.Tensor:
    """The decode cache of one layer from its ``(B, S, K, hd)`` keys or
    values: the last ``min(S, clen)`` positions at slots ``position % clen``."""
    b, s, kv, hd = t.shape
    clen = min(cache_len, window) if window > 0 else cache_len
    take = min(s, clen)
    # an out-of-place scatter along the positions (an expanded index: nothing materialized), which DTensor
    # takes where it has no rule for the indexed write `out[:, slots] = ...` nor for an in-place scatter (torch
    # 2.11); the same copies
    slots = (positions[-take:] % max(clen, 1)).view(1, take, 1, 1).expand(b, take, kv, hd)
    return t.new_zeros((b, clen, kv, hd)).scatter(1, slots, t[:, -take:])


def _mamba_with_state(p: Dict, h: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`~repro_torch.models.ssm.mamba_forward` that also returns the
    final ``(conv, ssm)`` states for decoding."""
    s = h.shape[1]
    kk = cfg.ssm_conv
    out, xin, h_final = ssm_mod.mamba_block(p, h, cfg)
    # the last k-1 inputs; a prompt shorter than that is padded with zeros in front
    conv_state = xin[:, -(kk - 1):] if s >= kk - 1 else F.pad(xin, (0, 0, kk - 1 - s, 0))
    return out, conv_state.contiguous(), h_final


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: the reference's
    ``dots_with_no_batch_dims_saveable`` on PyTorch's operators.  A
    projection ``(B, S, d) @ (d, n)`` folds to ``aten.mm`` (``aten.addmm``
    with a bias), whose output is saved; attention's einsums carry batch
    dimensions and go to ``aten.bmm``, which is recomputed with every
    other operator (norms, activations, the scan)."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def stack_forward(
    cfg: ModelConfig,
    layers: Dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    kind: str = "causal",
    prefix_len: int = 0,
    enc_kv_layers: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    collect_caches: bool = False,
    cache_len: int = 0,
):
    """Run the layer stack in a Python loop (the reference scans it).

    Returns ``(x, caches)``.  With ``collect_caches`` (prefill) the caches
    are in the decode layout ``{"sub<i>": {...}}``, each stacked on a
    leading ``num_groups`` axis; sublayer ``i`` of every group has the
    window ``_group_windows(cfg)[i]``.  Without it (training) ``caches`` is
    None, and with ``cfg.remat`` and grad mode on each layer group runs
    under ``torch.utils.checkpoint``: with ``remat_policy="dots"`` the
    outputs of its matrix products are kept and the rest is recomputed in
    the backward (:func:`_dots_policy`); with ``"full"`` all of it is, as
    the reference's ``jax.checkpoint`` of the scan body.  An
    encoder-decoder's ``enc_kv_layers`` are every decoder layer's cross
    keys and values, ``(L, B, S_enc, K, hd)`` each; layer ``l`` reads its
    slice (views, whose gradients reach the encoder under remat too).
    """
    gp = cfg.layer_group
    ng = cfg.num_layers // gp
    windows = _group_windows(cfg)
    per_layer = unstack_layers(layers, cfg.num_layers)
    # one unbind each, as for the parameters: the backward stacks the slices' gradients once
    enc_kv = (list(zip(torch.unbind(enc_kv_layers[0]), torch.unbind(enc_kv_layers[1]))) if enc_kv_layers is not None
              else [None] * cfg.num_layers)
    kw = dict(kind=kind, prefix_len=prefix_len)
    if collect_caches:
        collected: List[Dict[str, List[torch.Tensor]]] = [{} for _ in range(gp)]
        for g in range(ng):
            for i in range(gp):
                x, cache = _layer_fwd(cfg, per_layer[g * gp + i], x, positions, window=windows[i],
                                      enc_kv=enc_kv[g * gp + i], collect_cache=True, cache_len=cache_len, **kw)
                for name, t in cache.items():
                    collected[i].setdefault(name, []).append(t)
        return x, {f"sub{i}": {name: torch.stack(ts) for name, ts in c.items()} for i, c in enumerate(collected)}
    remat = cfg.remat and torch.is_grad_enabled()
    extra = {}
    if remat and cfg.remat_policy == "dots":
        extra["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)

    def group(x, g):
        for i in range(gp):
            x, _ = _layer_fwd(cfg, per_layer[g * gp + i], x, positions, window=windows[i], enc_kv=enc_kv[g * gp + i],
                              **kw)
        return x

    for g in range(ng):
        x = checkpoint(group, x, g, use_reentrant=False, **extra) if remat else group(x, g)
    return x, None
