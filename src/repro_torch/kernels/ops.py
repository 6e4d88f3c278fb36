"""Sort and top-k surface on the flat merge-sort rounds.

The counterpart of the reference's ``repro/kernels/ops.py`` for the dense
serving path: the batched key-value sort behind ``topk_batched``.  Narrow
rounds (``2 * width <= tile``) are plain batched merges on reshaped views
(:func:`repro_torch.core.merge_kv_batched`); wide rounds are launches of
:func:`repro_torch.kernels.merge_path.sort_round_kv`, which share one
sentinel/zero tail appended once per sort, not once per round.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the
kernel's plain version.  There is no fallback chain from one to another.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import batched as _bat
from repro_torch.core import merge_path as _mp

from . import merge_path as _kern
from . import tune as _tune


def _sort_tile(n: int, tile: Optional[int], leaf: Optional[int]) -> Tuple[int, int]:
    """Fill unspecified tile/leaf from :func:`tune.pick`.  The flat rounds
    need ``tile | 2 * width`` with power-of-two widths, so a tile passed
    explicitly must be a power of two."""
    t, s = _tune.pick(n)
    tile = t if tile is None else tile
    leaf = s if leaf is None else leaf
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"sort tile must be a power of two (flat sort rounds require tile | 2 * width), got {tile}")
    return tile, max(1, min(leaf, tile))


def _sort_rounds_kv(
    kflat: torch.Tensor, vflat: torch.Tensor, m: int, tile: int, leaf: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bottom-up kv merge-sort rounds over a flat ``(B * m,)`` buffer of
    width-1 runs (``m`` = per-row power-of-two width, so no pair straddles
    two rows)."""
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
    bsz = keys.shape[0]
    kp = _bat._pad_rows_pow2(keys, _mp.max_sentinel(keys.dtype))
    vp = _bat._pad_rows_pow2(values, 0)
    m = kp.shape[1]
    ks, vs = _sort_rounds_kv(kp.reshape(-1), vp.reshape(-1), m, tile, leaf)
    return ks.reshape(bsz, m)[:, :n], vs.reshape(bsz, m)[:, :n]


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
    bsz, n = x.shape
    k = min(k, n)
    tile, leaf = _sort_tile(n, tile, leaf)
    keys = _mp.total_order_keys(_mp.flip_desc(x))  # int keys: floats compare NaN-last
    idx = torch.arange(n, dtype=torch.int32, device=x.device).expand(bsz, n)
    _, perm = _sort_kv_batched_impl(keys, idx, n, tile, leaf)
    top_idx = perm[:, :k]
    return torch.gather(x, 1, top_idx.long()), top_idx
