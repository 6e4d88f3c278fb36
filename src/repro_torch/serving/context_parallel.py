"""Context-parallel decode attention over a sequence-sharded KV cache.

The port's copy of the reference's ``repro/serving/context_parallel.py``.
For long-context decode the cache's sequence dimension is split over the
ranks of a group.  Each rank computes attention over its own shard
(:func:`local_partial_attention`: the running max, the normalizer and the
weighted values), and the shards combine with the online-softmax reduction
(:func:`combine_partials`: one ``all_reduce(MAX)`` and two
``all_reduce(SUM)``), so the wire carries O(heads x head_dim) bytes a step
instead of the O(S) of gathering the cache.  It is the shape of the paper's
Theorem 5 (independent segment merges and a cheap combine), applied to
softmax attention.

Like the reference, no engine calls it: it is a module of functions, each
rank passing its own shard, as in the reference's ``shard_map`` body.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist


def local_partial_attention(
    q: torch.Tensor,  # (B, K, G, hd), the same on every rank
    k_shard: torch.Tensor,  # (B, S_local, K, hd)
    v_shard: torch.Tensor,  # (B, S_local, K, hd)
    valid: torch.Tensor,  # (B, S_local) bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This shard's float32 ``(m, l, o)``: the running max ``(B, K, G)``, the
    normalizer ``(B, K, G)`` and the weighted values ``(B, K, G, hd)``."""
    hd = q.shape[-1]
    s = torch.einsum("bkgh,bskh->bkgs", q, k_shard).float() / math.sqrt(hd)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_shard.dtype), v_shard).float()
    return m, l, o


def combine_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, group=None) -> torch.Tensor:
    """The online-softmax combine over the ranks of ``group`` (the world
    when None): ``all_reduce(MAX)`` of ``m`` for the reference's ``pmax``,
    ``all_reduce(SUM)`` of the rescaled ``l`` and ``o`` for its ``psum``.
    Wire bytes: ``2 * B*K*G + B*K*G*hd`` floats, independent of S.  Returns
    the attention output ``(B, K, G, hd)`` in float32."""
    m_glob = m.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    scale = torch.exp(m - m_glob)
    l_glob = l * scale
    o_glob = o * scale[..., None]
    dist.all_reduce(l_glob, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(o_glob, op=dist.ReduceOp.SUM, group=group)
    return o_glob / torch.clamp(l_glob[..., None], min=1e-30)


def context_parallel_decode_attention(
    q: torch.Tensor,  # (B, K, G, hd)
    k_shard: torch.Tensor,
    v_shard: torch.Tensor,
    valid: torch.Tensor,
    group=None,
) -> torch.Tensor:
    """One rank's whole context-parallel decode attention: its partials over
    its cache shard, combined over ``group``."""
    m, l, o = local_partial_attention(q, k_shard, v_shard, valid)
    return combine_partials(m, l, o, group)
