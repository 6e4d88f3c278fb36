"""Batched and k-way Merge Path: the paper's partition over a leading batch axis.

The PyTorch counterpart of the reference's ``repro.core.batched``:
Algorithm 2 over rows and over tile windows, the batched merges (keys
only and key-value) that carry the sorts' narrow rounds, their ragged
forms, the pure-PyTorch ("core") sorts and top-k, and the k-way merges.

Conventions match :mod:`repro_torch.core.merge_path`: rows sorted
ascending, merges stable with A-priority.  Sentinel padding is used for
the power-of-two round structure; payloads equal to the sentinel are
safe because pads are always appended after the real data and ties keep
the earlier position.  The ragged forms carry per-row valid lengths (each
row's data is a sorted prefix of its storage row) and exclude the tails
by length, never by comparing against the sentinel.
"""

from __future__ import annotations

from functools import reduce
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import is_dtensor

from .merge_path import (
    bisect,
    bisect_steps,
    flip_desc,
    max_sentinel,
    min_sentinel,
    result_type,
    total_order_keys,
)

__all__ = [
    "searchsorted_batched",
    "diagonal_intersections_batched",
    "diagonal_intersections_ragged",
    "window_intersections",
    "merge_batched",
    "merge_kv_batched",
    "merge_batched_ragged",
    "merge_kv_batched_ragged",
    "merge_sort_batched",
    "merge_sort_kv_batched",
    "merge_sort_batched_ragged",
    "merge_sort_kv_batched_ragged",
    "stable_argsort_batched",
    "stable_argsort_batched_ragged",
    "topk_batched",
    "topk_batched_ragged",
    "merge_k",
    "merge_k_kv",
    "merge_k_onepass",
    "merge_sort_k",
]

Runs = Union[torch.Tensor, Sequence[torch.Tensor]]


def _scatter_rows(out: torch.Tensor, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out.scatter_(1, index, src)``, in place on plain tensors; out of
    place when the operands are DTensors (the dry run), since ``out``, a
    fresh buffer, is then a plain tensor, which DTensor refuses to write
    sharded results into in place."""
    if is_dtensor(src) or is_dtensor(index):
        return out.scatter(1, index, src)
    return out.scatter_(1, index, src)


def _scatter2(out: torch.Tensor, ia: torch.Tensor, a: torch.Tensor, ib: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``out`` with ``a`` scattered to ``ia`` and ``b`` to ``ib`` along dim 1 (:func:`_scatter_rows`)."""
    return _scatter_rows(_scatter_rows(out, ia, a), ib, b)


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


def diagonal_intersections_ragged(
    a: torch.Tensor, b: torch.Tensor, a_lens, b_lens, diags: torch.Tensor
) -> torch.Tensor:
    """Algorithm 2 over rows with per-row valid lengths.

    Like :func:`diagonal_intersections_batched`, but row ``r``'s inputs are
    the sorted prefixes ``a[r, :a_lens[r]]`` and ``b[r, :b_lens[r]]``, and
    ``diags`` must lie in ``[0, a_lens[r] + b_lens[r]]`` (clip before
    calling).  The interval is bounded by the row's lengths, so no probe
    lands in a tail, whatever the tails hold.
    """
    bsz, na = a.shape
    nb = b.shape[1]
    a_lens = _as_lens(a_lens, bsz, na, a.device)
    b_lens = _as_lens(b_lens, bsz, nb, a.device)
    diags = torch.as_tensor(diags, dtype=torch.int32, device=a.device)
    if diags.ndim == 1:
        diags = diags[None, :].expand(bsz, diags.shape[0])
    if na == 0 or nb == 0:
        return torch.minimum(diags, a_lens[:, None])

    def probe(mid):
        av = torch.gather(a, 1, torch.clamp(mid, 0, na - 1).long())
        bv = torch.gather(b, 1, torch.clamp(diags - 1 - mid, 0, nb - 1).long())
        return av <= bv

    lo = torch.clamp(diags - b_lens[:, None], min=0)
    hi = torch.minimum(diags, a_lens[:, None])
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
    return _scatter2(out, ia, a, ib, b)


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
    keys = _scatter2(keys, ia, ak, ib, bk)
    vals = torch.empty((bsz, na + nb), dtype=vd, device=ak.device)
    return keys, _scatter2(vals, ia, av.to(vd), ib, bv.to(vd))


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


# ---------------------------------------------------------------------------
# ragged rows: per-row valid lengths
# ---------------------------------------------------------------------------
#
# Each row's data is a sorted prefix of a fixed-width storage row; the
# tail's contents are ignored.  Output rows hold the merged valid
# elements first and sentinel padding after.  Ranks are length-aware, so
# payloads equal to the sentinel (real ``+inf`` keys, ``iinfo.max``) merge
# correctly in the key-value forms too.


def _as_lens(lens, bsz: int, n: int, device=None) -> torch.Tensor:
    """A lengths argument as a ``(B,)`` int32 vector clipped to ``[0, n]``;
    a scalar broadcasts."""
    lens = torch.as_tensor(lens, device=device)
    if lens.ndim == 0:
        lens = lens.expand(bsz)
    if tuple(lens.shape) != (bsz,):
        raise ValueError(f"expected lengths of shape ({bsz},), got {tuple(lens.shape)}")
    return torch.clamp(lens, 0, n).to(torch.int32)


def _mask_rows(x: torch.Tensor, lens: torch.Tensor, fill) -> torch.Tensor:
    """Replace the entries at and after each row's length with ``fill``."""
    col = torch.arange(x.shape[1], device=x.device)[None, :]
    return torch.where(col < lens[:, None], x, torch.full((), fill, dtype=x.dtype, device=x.device))


def _ragged_ranks(
    a: torch.Tensor, b: torch.Tensor, a_lens: torch.Tensor, b_lens: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Length-aware cross-ranks (int64); pad entries rank ``na + nb``, one
    past the output row.

    ``a`` and ``b`` must be sentinel-masked past their lengths, so that
    rows are sorted.  The ``left`` search never counts pads (nothing is
    below the sentinel); the ``right`` search is capped at the other row's
    valid length, so pads tied with a sentinel-valued payload are not
    counted.
    """
    na, nb = a.shape[1], b.shape[1]
    ia = torch.arange(na, device=a.device)[None, :]
    ib = torch.arange(nb, device=a.device)[None, :]
    ra = ia + torch.minimum(searchsorted_batched(b, a, side="left"), b_lens[:, None])
    rb = ib + torch.minimum(searchsorted_batched(a, b, side="right"), a_lens[:, None])
    ra = torch.where(ia < a_lens[:, None], ra, na + nb)
    rb = torch.where(ib < b_lens[:, None], rb, na + nb)
    return ra, rb


def _ragged_prep(a: torch.Tensor, b: torch.Tensor, a_lens, b_lens):
    """Check the batch, clip the lengths, cast to the common dtype and
    mask the tails: ``(a, b, a_lens, b_lens)``."""
    bsz, na = a.shape
    nb = b.shape[1]
    if b.shape[0] != bsz:
        raise ValueError(f"batch mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")
    a_lens = _as_lens(a_lens, bsz, na, a.device)
    b_lens = _as_lens(b_lens, bsz, nb, a.device)
    dtype = result_type(a.dtype, b.dtype)
    sent = max_sentinel(dtype)
    return _mask_rows(a.to(dtype), a_lens, sent), _mask_rows(b.to(dtype), b_lens, sent), a_lens, b_lens


def merge_batched_ragged(a: torch.Tensor, b: torch.Tensor, a_lens, b_lens) -> torch.Tensor:
    """Stable merge of ``B`` row pairs with per-row valid lengths.

    ``a`` is ``(B, na)``, ``b`` is ``(B, nb)``; row ``r``'s data is the
    sorted prefix ``a[r, :a_lens[r]]`` / ``b[r, :b_lens[r]]`` (lengths are
    clipped to ``[0, n]``; a scalar broadcasts).  Returns ``(B, na + nb)``
    whose row ``r`` starts with the stable A-priority merge of the two
    prefixes, followed by sentinel padding.
    """
    am, bm, a_lens, b_lens = _ragged_prep(a, b, a_lens, b_lens)
    ra, rb = _ragged_ranks(am, bm, a_lens, b_lens)
    n = am.shape[1] + bm.shape[1]
    out = torch.full((am.shape[0], n + 1), max_sentinel(am.dtype), dtype=am.dtype, device=am.device)
    return _scatter2(out, ra, am, rb, bm)[:, :n]  # column n takes the pads


def merge_kv_batched_ragged(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, a_lens, b_lens
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged stable key-value merge; see :func:`merge_batched_ragged`.

    Values past a row's merged length are zero (their keys are sentinel).
    Pads are excluded from the ranks by length, so they never shadow a
    real ``+inf`` / ``iinfo.max`` key and leak a zero value.
    """
    if av.shape != ak.shape or bv.shape != bk.shape:
        raise ValueError(
            f"value shapes must match key shapes: keys {tuple(ak.shape)}/{tuple(bk.shape)}, "
            f"values {tuple(av.shape)}/{tuple(bv.shape)}"
        )
    akm, bkm, a_lens, b_lens = _ragged_prep(ak, bk, a_lens, b_lens)
    ra, rb = _ragged_ranks(akm, bkm, a_lens, b_lens)
    bsz, n = akm.shape[0], akm.shape[1] + bkm.shape[1]
    vd = result_type(av.dtype, bv.dtype)
    keys = torch.full((bsz, n + 1), max_sentinel(akm.dtype), dtype=akm.dtype, device=akm.device)
    keys = _scatter2(keys, ra, akm, rb, bkm)
    vals = _scatter2(torch.zeros((bsz, n + 1), dtype=vd, device=akm.device), ra, av.to(vd), rb, bv.to(vd))
    return keys[:, :n], vals[:, :n]


def merge_sort_batched_ragged(x: torch.Tensor, lens) -> torch.Tensor:
    """Sort each row's valid prefix ascending; the tail slots become sentinel.

    Pads are masked before the sort, and stability keeps real
    sentinel-valued keys ahead of them.  Float rows mask in int
    total-order key space, where the pad sorts strictly above every real
    key (NaN and ``+inf`` included), so NaN stays inside the prefix.
    """
    bsz, n = x.shape
    lens = _as_lens(lens, bsz, n, x.device)
    if x.is_floating_point():
        tok = total_order_keys(x)
        _, out = merge_sort_kv_batched(_mask_rows(tok, lens, max_sentinel(tok.dtype)), x)
        return _mask_rows(out, lens, max_sentinel(x.dtype))
    return merge_sort_batched(_mask_rows(x, lens, max_sentinel(x.dtype)))


def merge_sort_kv_batched_ragged(
    keys: torch.Tensor, values: torch.Tensor, lens
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged row-wise stable key-value sort (keys ascending over each prefix).

    Row ``r``'s first ``lens[r]`` pairs are its valid pairs, stably
    sorted; the tail carries sentinel keys with the masked slots' own
    values in their original order, so each value row stays a permutation
    of its input.
    """
    bsz, n = keys.shape
    lens = _as_lens(lens, bsz, n, keys.device)
    if keys.is_floating_point():
        tok = total_order_keys(keys)
        idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(bsz, n)
        _, perm = merge_sort_kv_batched(_mask_rows(tok, lens, max_sentinel(tok.dtype)), idx)
        perm = perm.long()
        ks = _mask_rows(torch.gather(keys, 1, perm), lens, max_sentinel(keys.dtype))
        return ks, torch.gather(values, 1, perm)
    return merge_sort_kv_batched(_mask_rows(keys, lens, max_sentinel(keys.dtype)), values)


def stable_argsort_batched_ragged(keys: torch.Tensor, lens) -> torch.Tensor:
    """Ragged row-wise stable argsort (int32): row ``r`` starts with the
    stable argsort of ``keys[r, :lens[r]]``, and the tail lists the masked
    positions in order (a full permutation)."""
    bsz, n = keys.shape
    idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(bsz, n)
    _, perm = merge_sort_kv_batched_ragged(keys, idx, lens)
    return perm


def topk_batched_ragged(x: torch.Tensor, k: int, lens) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise descending top-k over each row's valid prefix.

    Returns ``(values, int32 indices)``, each ``(B, min(k, n))``.  Slots
    ``j >= lens[r]`` return index ``-1`` and the dtype's minimum value.
    Ties go to the smallest index, and ints are exact at ``iinfo.min``
    (:func:`~repro_torch.core.flip_desc`).
    """
    bsz, n = x.shape
    k = min(k, n)
    lens = _as_lens(lens, bsz, n, x.device)
    top_idx = stable_argsort_batched_ragged(flip_desc(x), lens)[:, :k]
    return _mask_topk(x, top_idx, lens)


def _mask_topk(x: torch.Tensor, top_idx: torch.Tensor, lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the top-k values; slots past a row's length get the dtype's
    minimum and index ``-1``."""
    vals = torch.gather(x, 1, top_idx.long())
    return _mask_rows(vals, lens, min_sentinel(x.dtype)), _mask_rows(top_idx, lens, -1)


# ---------------------------------------------------------------------------
# k-way merges
# ---------------------------------------------------------------------------


def _stack_runs(runs: Runs, lens=None) -> Tuple[torch.Tensor, torch.Tensor, Optional[int]]:
    """A ``(k, n)`` tensor or a sequence of sorted 1-D runs as
    ``(stacked, lens, total)``.

    ``lens`` is the ``(k,)`` int32 valid length of each run.  ``total`` is
    the number of valid elements when it is known without reading the
    lengths' values (a sequence, or a tensor with no ``lens``), else
    ``None``, and the merged output is then not trimmed.  The runs of a
    sequence are padded with the sentinel to the longest.
    """
    if isinstance(runs, torch.Tensor):
        if runs.ndim != 2:
            raise ValueError(f"expected (k, n) runs, got shape {tuple(runs.shape)}")
        k, n = runs.shape
        if lens is None:
            return runs, torch.full((k,), n, dtype=torch.int32, device=runs.device), k * n
        return runs, _as_lens(lens, k, n, runs.device), None
    if lens is not None:
        raise ValueError("lens is only valid with a stacked (k, n) runs tensor")
    runs = list(runs)
    if not runs:
        raise ValueError("merge_k needs at least one run")
    dtype = reduce(result_type, (r.dtype for r in runs))
    width = max(r.shape[0] for r in runs)
    sent = max_sentinel(dtype)
    stacked = torch.full((len(runs), width), sent, dtype=dtype, device=runs[0].device)
    for i, r in enumerate(runs):
        stacked[i, : r.shape[0]] = r.to(dtype)
    run_lens = torch.tensor([r.shape[0] for r in runs], dtype=torch.int32, device=stacked.device)
    return stacked, run_lens, sum(r.shape[0] for r in runs)


def _pad_runs_pow2(stacked: torch.Tensor, run_lens: torch.Tensor, fill) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad the run axis to a power of two with zero-length rows of ``fill``."""
    k = stacked.shape[0]
    target = 1 << max(0, (k - 1).bit_length())
    if target == k:
        return stacked, run_lens
    pad = torch.full((target - k, stacked.shape[1]), fill, dtype=stacked.dtype, device=stacked.device)
    zeros = torch.zeros(target - k, dtype=torch.int32, device=stacked.device)
    return torch.cat([stacked, pad]), torch.cat([run_lens, zeros])


def merge_k(runs: Runs, lens=None) -> torch.Tensor:
    """Merge ``k`` sorted runs into one sorted array by a pairwise tournament.

    ``runs`` is a ``(k, n)`` tensor of sorted rows, or a sequence of sorted
    1-D tensors (possibly of different lengths).  With a tensor, ``lens``
    optionally gives each row's valid length (the tail is ignored).  The
    tournament runs ``ceil(log2 k)`` rounds, each one
    :func:`merge_batched_ragged` call over the pairs of runs (the run count
    padded to a power of two with zero-length runs).  Stable across runs
    in input order.  Output: the valid elements merged, then sentinel
    padding; trimmed to the total when it is known without ``lens``, else
    ``(k * n,)`` wide.
    """
    stacked, run_lens, total = _stack_runs(runs, lens)
    if total is None:  # the k == 1 identity runs no round: mask its tail here
        stacked = _mask_rows(stacked, run_lens, max_sentinel(stacked.dtype))
    k, n = stacked.shape
    stacked, run_lens = _pad_runs_pow2(stacked, run_lens, max_sentinel(stacked.dtype))
    while stacked.shape[0] > 1:
        stacked = merge_batched_ragged(stacked[0::2], stacked[1::2], run_lens[0::2], run_lens[1::2])
        run_lens = run_lens[0::2] + run_lens[1::2]
    out = stacked[0][: k * n]  # the power-of-two pad rows add only trailing sentinels
    return out if total is None else out[:total]


def merge_k_kv(key_runs: Runs, value_runs: Runs, lens=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value :func:`merge_k`: merge ``k`` sorted ``(keys, values)`` runs.

    Matching ``(k, n)`` tensors or sequences of matching 1-D runs; ``lens``
    as in :func:`merge_k`.  Output: the merged valid pairs, then sentinel
    keys with zero values.  Lengths, not sentinel comparisons, exclude the
    padding, so keys equal to the sentinel keep their values.
    """
    kstack, run_lens, total = _stack_runs(key_runs, lens)
    if isinstance(value_runs, torch.Tensor):
        vstack = value_runs
    else:
        value_runs = list(value_runs)
        vd = reduce(result_type, (v.dtype for v in value_runs))
        vstack = torch.zeros(kstack.shape, dtype=vd, device=kstack.device)
        for i, v in enumerate(value_runs):
            vstack[i, : v.shape[0]] = v.to(vd)
    if vstack.shape != kstack.shape:
        raise ValueError(f"key runs {tuple(kstack.shape)} and value runs {tuple(vstack.shape)} differ")
    if total is None:  # see merge_k
        kstack = _mask_rows(kstack, run_lens, max_sentinel(kstack.dtype))
        vstack = _mask_rows(vstack, run_lens, 0)
    k, n = kstack.shape
    kstack, _ = _pad_runs_pow2(kstack, run_lens, max_sentinel(kstack.dtype))
    vstack, run_lens = _pad_runs_pow2(vstack, run_lens, 0)
    while kstack.shape[0] > 1:
        kstack, vstack = merge_kv_batched_ragged(
            kstack[0::2], vstack[0::2], kstack[1::2], vstack[1::2], run_lens[0::2], run_lens[1::2]
        )
        run_lens = run_lens[0::2] + run_lens[1::2]
    end = k * n if total is None else total
    return kstack[0][:end], vstack[0][:end]


def merge_k_onepass(runs: Runs, lens=None) -> torch.Tensor:
    """Merge ``k`` sorted runs in one multiway co-rank pass, with no rounds.

    The contract of :func:`merge_k`.  Each element's output position is
    its own index plus, for every other run, the count of that run's valid
    elements that precede it: ``side="right"`` against lower runs (their
    ties come first) and ``side="left"`` against higher runs.  That is
    the stable multiway co-rank partition: ``O(k^2)`` rank searches but a
    single scatter over the data.  Counts are capped at the runs' lengths,
    so pads are excluded by count.
    """
    stacked, run_lens, total = _stack_runs(runs, lens)
    k, n = stacked.shape
    sent = max_sentinel(stacked.dtype)
    sm = _mask_rows(stacked, run_lens, sent)
    if k == 1:
        return sm[0] if total is None else stacked[0][:total]
    out = torch.full((k * n + 1,), sent, dtype=stacked.dtype, device=stacked.device)
    t = torch.arange(n, device=stacked.device)
    jidx = torch.arange(k, device=stacked.device)[:, None]
    cap = run_lens.long()[:, None]
    for j in range(k):
        q = sm[j][None, :].expand(k, n)
        cl = torch.minimum(searchsorted_batched(sm, q, side="left"), cap)
        cr = torch.minimum(searchsorted_batched(sm, q, side="right"), cap)
        cross = torch.where(jidx < j, cr, cl)
        cross = torch.where(jidx == j, 0, cross)
        rank = torch.where(t < run_lens[j], t + cross.sum(dim=0), k * n)  # pads go to the last slot
        out.scatter_(0, rank, sm[j])
    out = out[: k * n]
    return out if total is None else out[:total]


def _merge_k_groups(runs: torch.Tensor) -> torch.Tensor:
    """Merge every group of ``k`` sorted runs in one co-rank pass.

    ``runs`` is ``(G, k, w)``.  An element of run ``j`` lands at its own
    index plus, for every other run ``j'``, the count of that run's
    elements that precede it (``side="right"`` for ``j' < j``, ``"left"``
    for ``j' > j``).  Returns ``(G, k * w)``.
    """
    g, k, w = runs.shape
    out = torch.zeros((g, k * w), dtype=runs.dtype, device=runs.device)
    for j in range(k):
        q = runs[:, j]
        rank = torch.arange(w, device=runs.device)[None, :].expand(g, w)
        for jp in range(k):
            if jp != j:
                rank = rank + searchsorted_batched(runs[:, jp], q, side="right" if jp < j else "left")
        out.scatter_(1, rank, q)
    return out


def merge_sort_k(x: torch.Tensor, k: int = 4) -> torch.Tensor:
    """Bottom-up merge sort of a 1-D array with fan-in ``k`` multiway rounds.

    ``k`` must be a power of two.  Each round merges every group of ``k``
    consecutive sorted runs in one co-rank pass (:func:`_merge_k_groups`),
    so the data is rewritten ``ceil(log_k N)`` times instead of
    ``log2 N``.  With ``k = 2`` it is the paper's pairwise merge sort.
    """
    if k < 1 or k & (k - 1):
        raise ValueError(f"fan-in k must be a power of two, got {k}")
    n = x.shape[0]
    if n <= 1:
        return x
    xp = _pad_rows_pow2(x[None, :], max_sentinel(x.dtype))[0]
    m = xp.shape[0]
    fan_max = max(k, 2)  # k = 1 is the pairwise sort
    width = 1
    while width < m:
        fan = min(fan_max, m // width)  # the last round may have fewer runs than k
        xp = _merge_k_groups(xp.reshape(-1, fan, width)).reshape(-1)
        width *= fan
    return xp[:n]
