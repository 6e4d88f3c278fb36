"""Batched Merge Path: the paper's partition over a leading batch axis.

The PyTorch counterpart of the reference's ``repro.core.batched``, cut to
what the ported paths need: Algorithm 2 over rows and over tile windows,
the batched merges (keys only and key-value) that carry the sorts' narrow
rounds, and the pure-PyTorch ("core") sorts and top-k.

Conventions match :mod:`repro_torch.core.merge_path`: rows sorted
ascending, merges stable with A-priority.  Sentinel padding is used for
the power-of-two round structure; payloads equal to the sentinel are
safe because pads are always appended after the real data and ties keep
the earlier position.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .merge_path import bisect, bisect_steps, flip_desc, max_sentinel, result_type, total_order_keys

__all__ = [
    "searchsorted_batched",
    "diagonal_intersections_batched",
    "window_intersections",
    "merge_batched",
    "merge_kv_batched",
    "merge_sort_batched",
    "merge_sort_kv_batched",
    "stable_argsort_batched",
    "topk_batched",
]


def searchsorted_batched(sorted_rows: torch.Tensor, queries: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Row-wise insertion points, ``(B, m)`` int64.

    ``side="left"`` counts ``|{j : row[j] < q}|`` and ``side="right"``
    counts ``|{j : row[j] <= q}|``: the two tie orientations that make the
    merge stable with A-priority.  The reference runs this as its own
    fixed-trip bisection; the answer is unique, so ``torch.searchsorted``
    gives the same integers in one call.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    return torch.searchsorted(sorted_rows.contiguous(), queries.contiguous(), side=side)


def diagonal_intersections_batched(a: torch.Tensor, b: torch.Tensor, diags: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 over rows and diagonals at once.

    ``a`` is ``(B, na)``, ``b`` is ``(B, nb)``, ``diags`` is ``(D,)`` or
    ``(B, D)`` with ints in ``[0, na + nb]``.  Returns int32 ``ai`` of
    shape ``(B, D)``: the first ``d`` outputs of the stable merge of row
    ``r`` are ``a[r, :ai]`` and ``b[r, :d - ai]``.
    """
    bsz, na = a.shape
    nb = b.shape[1]
    diags = torch.as_tensor(diags, dtype=torch.int32, device=a.device)
    if diags.ndim == 1:
        diags = diags[None, :].expand(bsz, diags.shape[0])
    if nb == 0:
        return torch.clamp(diags, max=na)
    if na == 0:
        return torch.zeros_like(diags)

    def probe(mid):
        av = torch.gather(a, 1, torch.clamp(mid, 0, na - 1).long())
        bv = torch.gather(b, 1, torch.clamp(diags - 1 - mid, 0, nb - 1).long())
        return av <= bv

    lo = torch.clamp(diags - nb, min=0)
    hi = torch.clamp(diags, max=na)
    return bisect(lo, hi, bisect_steps(min(na, nb)), probe)


def window_intersections(
    wa: torch.Tensor,
    wb: torch.Tensor,
    diags: torch.Tensor,
    valid_a: Optional[int] = None,
    valid_b: Optional[int] = None,
) -> torch.Tensor:
    """Algorithm 2 over two fixed-size sorted windows (the tile body's
    level-2 split).

    Returns int32 ``ai`` (D,) such that the first ``d`` outputs of the
    stable merge of the windows are ``wa[:ai]`` and ``wb[:d-ai]``.  With
    ``valid_a``/``valid_b`` the interval is bounded by the windows'
    real-data prefixes, so no probe compares against padding; callers clamp
    ``diags`` to ``valid_a + valid_b`` first.
    """
    na, nb = wa.shape[0], wb.shape[0]
    diags = torch.as_tensor(diags, dtype=torch.int32, device=wa.device)
    if valid_a is None:
        lo = torch.clamp(diags - nb, min=0)
        hi = torch.clamp(diags, max=na)
    else:
        lo = torch.clamp(diags - valid_b, min=0)
        hi = torch.clamp(diags, max=valid_a)

    def probe(mid):
        av = wa[torch.clamp(mid, 0, na - 1).long()]
        bv = wb[torch.clamp(diags - 1 - mid, 0, nb - 1).long()]
        return av <= bv

    return bisect(lo, hi, bisect_steps(min(na, nb)), probe)


def _batched_ranks(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-ranks (int64) of every element of every row pair, in one pass."""
    dev = a.device
    ia = torch.arange(a.shape[1], device=dev)[None, :] + searchsorted_batched(b, a, side="left")
    ib = torch.arange(b.shape[1], device=dev)[None, :] + searchsorted_batched(a, b, side="right")
    return ia, ib


def merge_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge of ``B`` pairs of sorted rows: ``(B, na) + (B, nb) -> (B, na + nb)``.

    Row ``r`` is exactly ``merge(a[r], b[r])`` (stable, A-priority): every
    element's output position is its cross-rank, found for all rows at once.
    """
    dtype = result_type(a.dtype, b.dtype)
    a, b = a.to(dtype), b.to(dtype)
    ia, ib = _batched_ranks(a, b)
    out = torch.empty((a.shape[0], a.shape[1] + b.shape[1]), dtype=dtype, device=a.device)
    return out.scatter_(1, ia, a).scatter_(1, ib, b)


def merge_kv_batched(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable batched key-value merge: ``(B, na) + (B, nb) -> (B, na + nb)``.

    Every element's output position is its cross-rank (its own index plus
    the count of the other row's elements that precede it), so all rows
    merge in one pass: the "all diagonals at once" reading of the paper.
    """
    bsz, na = ak.shape
    nb = bk.shape[1]
    kd = result_type(ak.dtype, bk.dtype)
    vd = result_type(av.dtype, bv.dtype)
    ak, bk = ak.to(kd), bk.to(kd)
    ia, ib = _batched_ranks(ak, bk)
    keys = torch.empty((bsz, na + nb), dtype=kd, device=ak.device)
    keys.scatter_(1, ia, ak).scatter_(1, ib, bk)
    vals = torch.empty((bsz, na + nb), dtype=vd, device=ak.device)
    vals.scatter_(1, ia, av.to(vd)).scatter_(1, ib, bv.to(vd))
    return keys, vals


def _pad_rows_pow2(x: torch.Tensor, fill) -> torch.Tensor:
    """Pad the last axis of ``(B, n)`` to the next power of two with ``fill``."""
    n = x.shape[1]
    m = 1 << max(0, (n - 1).bit_length())
    if m == n:
        return x
    pad = torch.full((x.shape[0], m - n), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def merge_sort_batched(x: torch.Tensor) -> torch.Tensor:
    """Sort every row of ``(B, n)`` ascending by batched Merge Path rounds.

    Each of the ``log2 n`` rounds merges all runs of all rows in one
    :func:`merge_batched` call.  Float rows compare their int
    :func:`total_order_keys` (NaN last) and carry the floats as values, so
    equal floats (``-0.0`` and ``+0.0`` among them) keep their input order.
    """
    bsz, n = x.shape
    if n <= 1:
        return x
    if x.is_floating_point():
        _, out = merge_sort_kv_batched(total_order_keys(x), x)
        return out
    xp = _pad_rows_pow2(x, max_sentinel(x.dtype))
    m = xp.shape[1]
    width = 1
    while width < m:
        runs = xp.reshape(-1, 2, width)
        xp = merge_batched(runs[:, 0], runs[:, 1]).reshape(bsz, m)
        width *= 2
    return xp[:, :n]


def merge_sort_kv_batched(keys: torch.Tensor, values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable key-value sort of ``(B, n)`` keys (ascending).

    ``log2 n`` rounds of :func:`merge_kv_batched` over all runs of all
    rows.  Float keys take the NaN-deterministic route: the permutation
    comes from kv-sorting their int :func:`total_order_keys` (NaN last),
    and both keys and values are gathered through it.
    """
    bsz, n = keys.shape
    if n <= 1:
        return keys, values
    if keys.is_floating_point():
        idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(bsz, n)
        _, perm = merge_sort_kv_batched(total_order_keys(keys), idx)
        perm = perm.long()
        return torch.gather(keys, 1, perm), torch.gather(values, 1, perm)
    kp = _pad_rows_pow2(keys, max_sentinel(keys.dtype))
    vp = _pad_rows_pow2(values, 0)
    m = kp.shape[1]
    width = 1
    while width < m:
        kr = kp.reshape(-1, 2, width)
        vr = vp.reshape(-1, 2, width)
        kp, vp = merge_kv_batched(kr[:, 0], vr[:, 0], kr[:, 1], vr[:, 1])
        kp = kp.reshape(bsz, m)
        vp = vp.reshape(bsz, m)
        width *= 2
    return kp[:, :n], vp[:, :n]


def stable_argsort_batched(keys: torch.Tensor) -> torch.Tensor:
    """Row-wise stable argsort (ascending) of ``(B, n)`` keys, int32."""
    bsz, n = keys.shape
    idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(bsz, n)
    _, perm = merge_sort_kv_batched(keys, idx)
    return perm


def topk_batched(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise descending top-k of ``(B, n)``: ``(values, int32 indices)``.

    Stable: among equal values the smallest index wins, matching
    ``jax.lax.top_k``.  Descending order comes from :func:`flip_desc`.
    """
    perm = stable_argsort_batched(flip_desc(x))
    top_idx = perm[:, :k]
    return torch.gather(x, 1, top_idx.long()), top_idx
