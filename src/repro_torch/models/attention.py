"""Attention as plain tensor ops: full, blockwise (online softmax), sliding-window, decode.

The PyTorch counterpart of the reference's ``repro/models/attention.py``,
in its einsum form (no library attention kernel).  Layouts are the
reference's: activations ``(B, S, d)``, heads grouped as ``(B, S, K, G,
hd)`` for grouped-query attention, and decode caches ``(B, S_cache, K,
hd)`` per layer (a ring buffer when ``window > 0``).  Over a whole
sequence, :func:`attention` takes the dense masked path up to
``FULL_ATTENTION_THRESHOLD`` keys and :func:`_blockwise` past it (a loop
over KV chunks with a float32 running max, denominator and accumulator).
The decode cache is updated in place, where the reference returns a new
array: the caller's cache tensors are the state.  Cross-attention
(``attention(kv=...)`` over a whole sequence, :func:`cross_decode_attention`
for one token) reads keys and values precomputed from the encoder's
output, with no rotary embedding and no mask.  The activations pass
through :func:`~repro_torch.parallel.sharding.constrain` where the
reference constrains them (a no-op outside a sharding env).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import constrain, is_dtensor, write_token_sharded

from .layers import apply_rope, make_rope

NEG_INF = -1e30
FULL_ATTENTION_THRESHOLD = 8192


def qkv_proj(params: Dict, x: torch.Tensor, num_heads: int, num_kv: int, head_dim: int):
    """``x (B,S,d) -> q (B,S,H,hd), k/v (B,S,K,hd)``."""
    b, s, _ = x.shape
    # Each product is laid out before its split into heads, replicated over the tensor axis, as the reference
    # lays out k and v (it shards q's heads).  A DTensor sharded over the heads cannot split them into (kv heads,
    # group) where the tensor axis does not divide them evenly, nor can the attention's einsums merge a sharded
    # dimension into an outer one (torch 2.11), so the attention core is replicated over the tensor axis.
    q = constrain(x @ params["wq"], "act_batch", "act_seq", None).reshape(b, s, num_heads, head_dim)
    k = constrain(x @ params["wk"], "act_batch", "act_seq", None).reshape(b, s, num_kv, head_dim)
    v = constrain(x @ params["wv"], "act_batch", "act_seq", None).reshape(b, s, num_kv, head_dim)
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


def _blockwise(q, k, v, qpos, kind: str, window: int, prefix_len: int, chunk: int, softcap: float) -> torch.Tensor:
    """Online softmax over KV chunks: ``q (B,Sq,K,G,hd)``, ``k/v (B,Sk,K,hd)
    -> (B,Sq,K,G,hd)``.

    The reference's ``lax.scan`` becomes a Python loop over the chunks.
    The tail is padded to a whole chunk and masked by ``kpos < Sk``; the
    running ``(max, denominator, accumulator)`` are float32.  Each chunk's
    scores ``(B,K,G,Sq,chunk)`` float32 are freed before the next chunk's
    are made.
    """
    b, sq, kh, g, hd = q.shape
    sk = k.shape[1]
    nchunks = -(-sk // chunk)
    pad = nchunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qf = q.float()
    m_run = torch.full((b, kh, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((b, kh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kh, g, sq, hd), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        msk = _mask(qpos, kpos, kind, window, prefix_len) & (kpos < sk)[None, :]
        kb = k[:, ci * chunk:(ci + 1) * chunk].float()
        vb = v[:, ci * chunk:(ci + 1) * chunk].float()
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kb) / math.sqrt(hd)
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(msk[None, None, None], s, NEG_INF)
        m_new = torch.maximum(m_run, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        del s
        scale = torch.exp(m_run - m_new)
        l_run = l_run * scale + torch.sum(p, dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p, vb)
        m_run = m_new
        del p, kb, vb
    out = acc / torch.clamp(l_run[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)  # (B,Sq,K,G,hd)


def attention(
    params: Dict,
    x: torch.Tensor,
    *,
    num_heads: int,
    num_kv: int,
    head_dim: int,
    rope_theta: float,
    positions: torch.Tensor,  # (S,) absolute positions
    kind: str = "causal",  # causal | full | prefix
    window: int = 0,
    prefix_len: int = 0,
    chunk: int = 1024,
    softcap: float = 0.0,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    force_blockwise: bool = False,
) -> torch.Tensor:
    """Self (or cross, with ``kv``) attention over a whole sequence:
    ``x (B,S,d) -> (B,S,d)``.

    Dense masked attention while the keys number at most
    ``FULL_ATTENTION_THRESHOLD`` (and ``force_blockwise`` is off), the
    blockwise online softmax past it.  With ``kv = (k, v)``, each ``(B,
    Sk, K, hd)`` (the encoder output's projections), ``q`` is ``x @ wq``
    with no rotary embedding and every query sees every key.
    """
    if kv is not None:
        b, s, _ = x.shape
        k, v = kv
        q = constrain(x @ params["wq"], "act_batch", "act_seq", None).reshape(b, s, num_kv, num_heads // num_kv,
                                                                             head_dim)
        kpos = torch.arange(k.shape[1], device=x.device)
        if k.shape[1] <= FULL_ATTENTION_THRESHOLD and not force_blockwise:
            out = _sdpa(q, k, v, _mask(positions, kpos, "full", window, prefix_len), softcap)
        else:
            out = _blockwise(q, k, v, positions, "full", window, prefix_len, chunk, softcap)
        return constrain(out.reshape(b, s, num_heads * head_dim), "act_batch", "act_seq", "act_heads") @ params["wo"]
    return self_attention(
        params, x, num_heads=num_heads, num_kv=num_kv, head_dim=head_dim, rope_theta=rope_theta,
        positions=positions, kind=kind, window=window, prefix_len=prefix_len, chunk=chunk, softcap=softcap,
        force_blockwise=force_blockwise,
    )[0]


def self_attention(params: Dict, x: torch.Tensor, *, num_heads: int, num_kv: int, head_dim: int, rope_theta: float,
                   positions: torch.Tensor, kind: str, window: int, prefix_len: int, chunk: int, softcap: float,
                   force_blockwise: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`attention`'s output with its rotated ``k`` and its ``v``
    ``(B,S,K,hd)``, from which prefill fills the decode cache."""
    b, s, _ = x.shape
    g = num_heads // num_kv
    q, k, v = qkv_proj(params, x, num_heads, num_kv, head_dim)
    if rope_theta > 0:
        sin, cos = make_rope(positions, head_dim, rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    qh = q.reshape(b, s, num_kv, g, head_dim)
    if k.shape[1] <= FULL_ATTENTION_THRESHOLD and not force_blockwise:
        out = _sdpa(qh, k, v, _mask(positions, positions, kind, window, prefix_len), softcap)
    else:
        out = _blockwise(qh, k, v, positions, kind, window, prefix_len, chunk, softcap)
    out = constrain(out.reshape(b, s, num_heads * head_dim), "act_batch", "act_seq", "act_heads")
    return out @ params["wo"], k, v


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
    q, k, v = (constrain(x @ params[w], "act_batch", None, None).reshape(b, n, head_dim)
               for w, n in (("wq", num_heads), ("wk", num_kv), ("wv", num_kv)))
    if rope_theta > 0:
        sin, cos = make_rope(pos[:, None], head_dim, rope_theta)  # (B, 1, half)
        q = apply_rope(q.reshape(b, 1, num_heads, head_dim), sin, cos).reshape(b, num_heads, head_dim)
        k = apply_rope(k.reshape(b, 1, num_kv, head_dim), sin, cos).reshape(b, num_kv, head_dim)
    pos = pos.long()
    slot = pos % s_cache if window > 0 else torch.clamp(pos, max=s_cache - 1)
    if is_dtensor(cache_k):  # a sharded cache: each device writes its own shard (no copy of the cache)
        write_token_sharded(cache_k, slot, k)
        write_token_sharded(cache_v, slot, v)
    else:
        bidx = torch.arange(b, device=x.device)
        cache_k[bidx, slot] = k.to(cache_k.dtype)
        cache_v[bidx, slot] = v.to(cache_v.dtype)
    cache_k = constrain(cache_k, "act_batch", "act_kv_seq", None, None)
    cache_v = constrain(cache_v, "act_batch", "act_kv_seq", None, None)
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


def cross_decode_attention(params: Dict, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor, *, num_heads: int,
                           num_kv: int, head_dim: int) -> torch.Tensor:
    """Cross-attention for one decode step: ``x (B,1,d)`` against the
    encoder's ``xk``/``xv`` ``(B,S_enc,K,hd)``, every key seen: ``(B,1,d)``."""
    b = x.shape[0]
    q = (x @ params["wq"]).reshape(b, num_kv, num_heads // num_kv, head_dim)
    scores = torch.einsum("bkgh,bskh->bkgs", q, xk).float() / math.sqrt(head_dim)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("bkgs,bskh->bkgh", probs, xv).reshape(b, 1, num_heads * head_dim)
    return out @ params["wo"]
