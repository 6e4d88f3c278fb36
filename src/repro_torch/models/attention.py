"""Attention as plain tensor ops: projections, masked softmax, decode.

The PyTorch counterpart of the reference's ``repro/models/attention.py``
for the dense decode path.  Layouts are the reference's: activations
``(B, S, d)``, heads grouped as ``(B, S, K, G, hd)`` for grouped-query
attention, and decode caches ``(B, S_cache, K, hd)`` per layer (a ring
buffer when ``window > 0``).  The cache is updated in place, where the
reference returns a new array: the caller's cache tensors are the state.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .layers import apply_rope, make_rope

NEG_INF = -1e30


def qkv_proj(params: Dict, x: torch.Tensor, num_heads: int, num_kv: int, head_dim: int):
    """``x (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd)``."""
    b, s, _ = x.shape
    q = (x @ params["wq"]).reshape(b, s, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, s, num_kv, head_dim)
    v = (x @ params["wv"]).reshape(b, s, num_kv, head_dim)
    return q, k, v


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, kind: str, window: int, prefix_len: int) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if kind in ("causal", "prefix"):
        m = kpos[None, :] <= qpos[:, None]
        if kind == "prefix":
            m = m | (kpos[None, :] < prefix_len)
    if window > 0:
        m = m & (kpos[None, :] > qpos[:, None] - window)
    return m


def _sdpa(q, k, v, mask, softcap: float) -> torch.Tensor:
    """``q (B,Sq,K,G,hd)``, ``k/v (B,Sk,K,hd)``, ``mask (Sq,Sk) -> (B,Sq,K,G,hd)``."""
    hd = q.shape[-1]
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).float() / math.sqrt(hd)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def decode_attention(
    params: Dict,
    x: torch.Tensor,  # (B, 1, d)
    cache_k: torch.Tensor,  # (B, S_cache, K, hd), updated in place
    cache_v: torch.Tensor,
    pos: torch.Tensor,  # (B,) absolute position of the new token
    *,
    num_heads: int,
    num_kv: int,
    head_dim: int,
    rope_theta: float,
    window: int = 0,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One new token against the cache: ``(out (B,1,d), cache_k, cache_v)``."""
    b = x.shape[0]
    s_cache = cache_k.shape[1]
    g = num_heads // num_kv
    q = (x @ params["wq"]).reshape(b, num_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, num_kv, head_dim)
    v = (x @ params["wv"]).reshape(b, num_kv, head_dim)
    if rope_theta > 0:
        sin, cos = make_rope(pos[:, None], head_dim, rope_theta)  # (B, 1, half)
        q = apply_rope(q.reshape(b, 1, num_heads, head_dim), sin, cos).reshape(b, num_heads, head_dim)
        k = apply_rope(k.reshape(b, 1, num_kv, head_dim), sin, cos).reshape(b, num_kv, head_dim)
    pos = pos.long()
    slot = pos % s_cache if window > 0 else torch.clamp(pos, max=s_cache - 1)
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, slot] = k.to(cache_k.dtype)
    cache_v[bidx, slot] = v.to(cache_v.dtype)
    # absolute position held by each cache slot
    ridx = torch.arange(s_cache, device=x.device)[None, :]
    if window > 0:
        kpos = pos[:, None] - ((pos[:, None] - ridx) % s_cache)
    else:
        kpos = ridx.expand(b, s_cache)
    valid = (kpos <= pos[:, None]) & (kpos >= 0)
    if window > 0:
        valid = valid & (kpos > pos[:, None] - window)
    qh = q.reshape(b, num_kv, g, head_dim)
    scores = torch.einsum("bkgh,bskh->bkgs", qh, cache_k).float() / math.sqrt(head_dim)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, cache_v).reshape(b, 1, num_heads * head_dim)
    return out @ params["wo"], cache_k, cache_v
