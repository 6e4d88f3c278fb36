"""Meta-tensor inputs and shardings for every (arch x shape x mode) cell:
the dry run's contract with the model.

The port's copy of the reference's ``repro/launch/specs.py``.  Inputs are
meta tensors (shapes and dtypes, nothing allocated); shardings are trees
of :class:`~repro_torch.parallel.sharding.NamedSharding` (a mesh and the
DTensor placements of one leaf), each sanitized against its leaf's shape.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import AUDIO, VLM, ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import abstract_caches, abstract_params
from repro_torch.models.transformer import _dtype
from repro_torch.parallel.sharding import (
    MeshRules,
    canon_entry,
    named_sharding,
    param_pspec_tree,
    sanitize_spec,
    sanitized_sharding_tree,
)
from repro_torch.train.steps import abstract_train_state


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor of ``shape`` and ``dtype``: the reference's ``ShapeDtypeStruct``."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mode: str) -> Dict[str, Any]:
    """The abstract batch of a train or prefill cell."""
    b, s = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    out: Dict[str, Any] = {}
    if cfg.family == VLM:
        p = cfg.num_prefix_tokens
        out["prefix_emb"] = sds((b, p, cfg.d_model), dt)
        out["tokens"] = sds((b, s - p), torch.int32)
        if mode == "train":
            out["labels"] = sds((b, s - p), torch.int32)
        return out
    if cfg.family == AUDIO:
        out["frames"] = sds((b, cfg.encoder_seq, cfg.d_model), dt)
    out["tokens"] = sds((b, s), torch.int32)
    if mode == "train":
        out["labels"] = sds((b, s), torch.int32)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The abstract ``(caches, token, pos[, enc_kv])`` of one decode step
    with a cache of ``seq_len``."""
    b, s = shape.global_batch, shape.seq_len
    out = {"caches": abstract_caches(cfg, b, s), "token": sds((b, 1), torch.int32), "pos": sds((b,), torch.int32)}
    if cfg.is_encoder_decoder:
        ek = sds((cfg.num_layers, b, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim), _dtype(cfg))
        out["enc_kv"] = (ek, ek)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The abstract model inputs of the cell's mode."""
    if shape.mode in ("train", "prefill"):
        return batch_specs(cfg, shape, shape.mode)
    return decode_specs(cfg, shape)


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mode: str, mesh, rules: MeshRules) -> Dict[str, Any]:
    """The batch dimension of every input over ``rules.batch``."""
    bp = canon_entry(rules.batch)
    return {name: named_sharding(mesh, sanitize_spec((bp,) + (None,) * (leaf.ndim - 1), leaf.shape, mesh))
            for name, leaf in batch_specs(cfg, shape, mode).items()}


def cache_pspec_tree(cfg: ModelConfig, caches: Dict, rules: MeshRules) -> Dict:
    """Specs of the decode caches: the KV sequence over ``rules.context``
    (context-parallel over the model axis), the SSM and conv states'
    d_inner over ``rules.tensor``."""
    ctx = canon_entry(rules.context)
    bp = canon_entry(rules.batch)
    tensor = canon_entry(rules.tensor)

    def one(name):
        if name in ("k", "v"):
            return (None, bp, ctx, None, None)
        if name == "conv":
            return (None, bp, None, tensor)
        if name == "ssm":
            return (None, bp, tensor, None)
        return ()

    return {sub: {name: one(name) for name in leaves} for sub, leaves in caches.items()}


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh, rules: MeshRules, caches: Dict) -> Dict[str, Any]:
    dspec = decode_specs(cfg, shape)
    bp = canon_entry(rules.batch)

    def san(spec, leaf):
        return named_sharding(mesh, sanitize_spec(spec, leaf.shape, mesh))

    out = {
        "caches": sanitized_sharding_tree(caches, cache_pspec_tree(cfg, caches, rules), mesh),
        "token": san((bp, None), dspec["token"]),
        "pos": san((bp,), dspec["pos"]),
    }
    if cfg.is_encoder_decoder:
        ekv = san((None, bp, None, None, None), dspec["enc_kv"][0])
        out["enc_kv"] = (ekv, ekv)
    return out


def _cfg_spec_overrides(cfg: ModelConfig, pspecs: Dict, rules: MeshRules) -> Dict:
    """Config-aware overrides of the name-based rules.

    ``replicate_kv_proj``: with few kv heads a tensor-sharded wk/wv splits
    a head across devices; replicating their small output dimension keeps
    K and V whole at a small cost in flops.
    """
    if not cfg.replicate_kv_proj:
        return pspecs
    fsdp = canon_entry(rules.fsdp)

    def fix(block):
        for w in ("wk", "wv"):
            if isinstance(block, dict) and w in block:
                nd = len(block[w])
                block[w] = tuple([None] * (nd - 2) + [fsdp, None])

    scope = pspecs.get("layers", {})
    for key in ("attn", "cross"):
        if key in scope:
            fix(scope[key])
    if "encoder" in pspecs and "attn" in pspecs["encoder"].get("layers", {}):
        fix(pspecs["encoder"]["layers"]["attn"])
    return pspecs


def state_shardings(cfg: ModelConfig, tcfg: TrainConfig, mesh, rules: MeshRules):
    """``(abstract train state, its shardings)``: the float32 masters and
    the moments (and ``err``) on the parameters' specs, ``step``
    replicated."""
    state = abstract_train_state(cfg, tcfg)
    pspecs = _cfg_spec_overrides(cfg, param_pspec_tree(state["params"], rules), rules)

    def tree(specs):
        return sanitized_sharding_tree(state["params"], specs, mesh)

    shardings = {"step": named_sharding(mesh, ()), "params": tree(pspecs),
                 "opt": {"m": tree(pspecs), "v": tree(pspecs)}}
    if "err" in state:
        shardings["err"] = tree(pspecs)
    return state, shardings


def params_shardings(cfg: ModelConfig, mesh, rules: MeshRules):
    """``(abstract parameters in the model's dtypes, their shardings)``."""
    params = abstract_params(cfg)
    pspecs = _cfg_spec_overrides(cfg, param_pspec_tree(params, rules), rules)
    return params, sanitized_sharding_tree(params, pspecs, mesh)
