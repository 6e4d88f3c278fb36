"""Merge, sort and top-k surface on the hand-written Merge Path kernels.

The counterpart of the reference's ``repro/kernels/ops.py``, with its
dispatch:

* :func:`merge` / :func:`merge_kv`: the core rank merge when the whole
  merge fits in one tile (``n <= tile``), else one launch of K1 / K2;
* :func:`sort`, :func:`sort_kv`, :func:`sort_batched`,
  :func:`sort_kv_batched` and :func:`topk_batched`: bottom-up merge-sort
  rounds over a flat buffer of power-of-two rows.  Narrow rounds
  (``2 * width <= tile``) are plain batched merges on reshaped views
  (:func:`repro_torch.core.merge_batched` / ``merge_kv_batched``); wide
  rounds are launches of K3 (keys only) or K4 (key-value), which share
  one sentinel tail appended once per sort, not once per round.  Integer
  keys-only sorts run K3; float keys compare their int
  :func:`~repro_torch.core.total_order_keys` (NaN last) through K4 with
  an index payload, and the result is gathered through that permutation.

A CUDA tensor launches the kernels or raises; a CPU tensor runs their
plain versions.  There is no fallback chain from one to another.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import batched as _bat
from repro_torch.core import merge_path as _mp

from . import merge_path as _kern
from . import tune as _tune


def _resolve(n: int, tile: Optional[int], leaf: Optional[int]) -> Tuple[int, int]:
    """Fill unspecified tile/leaf from :func:`tune.pick`."""
    t, s = _tune.pick(n)
    tile = t if tile is None else tile
    leaf = s if leaf is None else leaf
    return tile, max(1, min(leaf, tile))


def _sort_tile(n: int, tile: Optional[int], leaf: Optional[int]) -> Tuple[int, int]:
    """Tile/leaf for the sorts.  The flat rounds need ``tile | 2 * width``
    with power-of-two widths, so a tile passed explicitly must be a power
    of two."""
    tile, leaf = _resolve(n, tile, leaf)
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"sort tile must be a power of two (flat sort rounds require tile | 2 * width), got {tile}")
    return tile, leaf


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------


def merge(a: torch.Tensor, b: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None) -> torch.Tensor:
    """Stable A-priority merge of two sorted 1-D arrays.

    The operands are cast to :func:`~repro_torch.core.result_type` (JAX's
    promotion for int16, int32, bfloat16 and float32).  One K1 launch when
    ``na + nb > tile``, the core rank merge otherwise.
    """
    n = a.shape[0] + b.shape[0]
    tile, leaf = _resolve(n, tile, leaf)
    dtype = _mp.result_type(a.dtype, b.dtype)
    if n <= tile:
        return _mp.merge(a, b)
    return _kern.merge(a.to(dtype).contiguous(), b.to(dtype).contiguous(), tile=tile, leaf=leaf)


def merge_kv(
    ak: torch.Tensor,
    av: torch.Tensor,
    bk: torch.Tensor,
    bv: torch.Tensor,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable A-priority key-value merge: one K2 launch when
    ``na + nb > tile``, the core rank merge otherwise."""
    n = ak.shape[0] + bk.shape[0]
    tile, leaf = _resolve(n, tile, leaf)
    kd = _mp.result_type(ak.dtype, bk.dtype)
    vd = _mp.result_type(av.dtype, bv.dtype)
    if n <= tile:
        return _mp.merge_kv(ak, av, bk, bv)
    return _kern.merge_kv(
        ak.to(kd).contiguous(), av.to(vd).contiguous(), bk.to(kd).contiguous(), bv.to(vd).contiguous(),
        tile=tile, leaf=leaf,
    )


# ---------------------------------------------------------------------------
# sorts: flat rounds, padding hoisted out of the loop
# ---------------------------------------------------------------------------


def _sort_rounds(flat: torch.Tensor, m: int, tile: int, leaf: int) -> torch.Tensor:
    """Bottom-up keys-only merge-sort rounds over a flat ``(B * m,)`` buffer
    of width-1 runs (``m`` = per-row power-of-two width, so no pair
    straddles two rows)."""
    width = 1
    while width < m and 2 * width <= tile:
        runs = flat.reshape(-1, 2, width)
        flat = _bat.merge_batched(runs[:, 0], runs[:, 1]).reshape(-1)
        width *= 2
    if width < m:
        total = flat.shape[0]
        xf = torch.cat([flat, torch.full((tile,), _mp.max_sentinel(flat.dtype), dtype=flat.dtype, device=flat.device)])
        while width < m:
            xf = _kern.sort_round(xf, width, tile=tile, leaf=leaf)
            width *= 2
        flat = xf[:total]
    return flat


def _sort_rounds_kv(
    kflat: torch.Tensor, vflat: torch.Tensor, m: int, tile: int, leaf: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value :func:`_sort_rounds` (the values' tail is zeros)."""
    width = 1
    while width < m and 2 * width <= tile:
        kr = kflat.reshape(-1, 2, width)
        vr = vflat.reshape(-1, 2, width)
        kflat, vflat = _bat.merge_kv_batched(kr[:, 0], vr[:, 0], kr[:, 1], vr[:, 1])
        kflat, vflat = kflat.reshape(-1), vflat.reshape(-1)
        width *= 2
    if width < m:
        total = kflat.shape[0]
        tail_k = torch.full((tile,), _mp.max_sentinel(kflat.dtype), dtype=kflat.dtype, device=kflat.device)
        kf = torch.cat([kflat, tail_k])
        vf = torch.cat([vflat, torch.zeros((tile,), dtype=vflat.dtype, device=vflat.device)])
        while width < m:
            kf, vf = _kern.sort_round_kv(kf, vf, width, tile=tile, leaf=leaf)
            width *= 2
        kflat, vflat = kf[:total], vf[:total]
    return kflat, vflat


def _sort_kv_batched_impl(
    keys: torch.Tensor, values: torch.Tensor, n: int, tile: int, leaf: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise key-value sort of integer ``(B, n)`` keys on K4."""
    bsz = keys.shape[0]
    kp = _bat._pad_rows_pow2(keys, _mp.max_sentinel(keys.dtype))
    vp = _bat._pad_rows_pow2(values, 0)
    m = kp.shape[1]
    ks, vs = _sort_rounds_kv(kp.reshape(-1), vp.reshape(-1), m, tile, leaf)
    return ks.reshape(bsz, m)[:, :n], vs.reshape(bsz, m)[:, :n]


def _argsort_batched(keys: torch.Tensor, n: int, tile: int, leaf: int) -> torch.Tensor:
    """Stable row-wise argsort (int32) of ``(B, n)`` keys: K4 over the int
    total-order keys (floats: NaN last) or the keys themselves, with an
    index payload."""
    idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(keys.shape[0], n)
    _, perm = _sort_kv_batched_impl(_mp.total_order_keys(keys), idx, n, tile, leaf)
    return perm


def sort_batched(x: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None) -> torch.Tensor:
    """Sort every row of ``(B, n)`` ascending.  The batch axis is folded into
    the run-pair axis, so a round is one launch whatever ``B`` is.

    Integer rows run the keys-only rounds (K3).  Float rows are gathered
    through the stable argsort of their total-order keys (K4), so NaN
    sorts last and equal floats (``-0.0`` and ``+0.0``) keep their order.
    """
    bsz, n = x.shape
    if n <= 1:
        return x
    tile, leaf = _sort_tile(n, tile, leaf)
    if x.is_floating_point():
        return torch.gather(x, 1, _argsort_batched(x, n, tile, leaf).long())
    xp = _bat._pad_rows_pow2(x, _mp.max_sentinel(x.dtype))
    m = xp.shape[1]
    return _sort_rounds(xp.reshape(-1), m, tile, leaf).reshape(bsz, m)[:, :n]


def sort_kv_batched(
    keys: torch.Tensor, values: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable key-value sort of ``(B, n)`` keys (ascending).

    Integer keys with int32 values run K4 directly; float keys, or values
    of another dtype, are gathered through the stable argsort.
    """
    bsz, n = keys.shape
    if n <= 1:
        return keys, values
    tile, leaf = _sort_tile(n, tile, leaf)
    if keys.is_floating_point() or values.dtype != torch.int32:
        perm = _argsort_batched(keys, n, tile, leaf).long()
        return torch.gather(keys, 1, perm), torch.gather(values, 1, perm)
    return _sort_kv_batched_impl(keys, values, n, tile, leaf)


def sort(x: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None) -> torch.Tensor:
    """Bottom-up merge sort of a 1-D array: :func:`sort_batched` of one row."""
    if x.shape[0] <= 1:
        return x
    return sort_batched(x[None, :], tile=tile, leaf=leaf)[0]


def sort_kv(
    keys: torch.Tensor, values: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value merge sort of 1-D arrays: :func:`sort_kv_batched` of one row."""
    if keys.shape[0] <= 1:
        return keys, values
    ks, vs = sort_kv_batched(keys[None, :], values[None, :], tile=tile, leaf=leaf)
    return ks[0], vs[0]


def topk_batched(
    x: torch.Tensor,
    k: int,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise descending top-k on the kernel-backed batched kv-sort.

    Same contract as :func:`repro_torch.core.topk_batched`: ``(values,
    int32 indices)``, each ``(B, min(k, n))``; stable, so among equal
    values the smallest index wins; exact at ``iinfo.min`` through
    ``flip_desc``; NaN candidates rank below every real value.  Runs on
    ``x``'s device: the sort rounds launch the K4 kernel for a CUDA ``x``.
    """
    if x.ndim != 2:
        raise ValueError(f"topk_batched expects (B, n) rows, got shape {tuple(x.shape)}")
    n = x.shape[1]
    k = min(k, n)
    tile, leaf = _sort_tile(n, tile, leaf)
    top_idx = _argsort_batched(_mp.flip_desc(x), n, tile, leaf)[:, :k]
    return torch.gather(x, 1, top_idx.long()), top_idx
