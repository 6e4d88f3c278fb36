"""Segmented Parallel Merge (SPM): Algorithm 3 of the paper.

The PyTorch counterpart of the reference's ``repro.core.segmented``.  The
paper cuts the Merge Path into cache-sized segments and merges one
segment at a time with all cores cooperating, so that everything live
stays in cache.  Here the schedule is the paper's: a loop walks the
segments in order, carrying the global ``(a_offset, b_offset)`` path
position (Algorithm 3's ``startingPoint``); inside a segment every rank
is computed at once.

Lemma 16 / Theorem 17: a segment of length L consumes at most L
consecutive elements of A and of B, so each step touches one window of
each.  ``|A| + |B|`` need not divide by the segment: the last segment is
short.  Windows that overrun an input are sentinel-padded, but the ranks
and the path's advance count only the windows' valid prefixes, so keys
equal to the sentinel merge correctly, in the key-value form too.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .merge_path import max_sentinel, result_type

__all__ = ["segmented_merge", "segmented_merge_kv"]


def _masked_window_ranks(
    wa: torch.Tensor, wb: torch.Tensor, valid_a: int, valid_b: int, out_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-ranks of two sorted windows that count only valid elements.

    Rank = own index + the number of valid elements of the other window
    that precede it (A-priority ties).  The ``left`` count never includes
    pads; the ``right`` count is capped at ``valid_a``.  Pads, and valid
    elements that rank past the segment (they belong to a later one), get
    ``out_len``, the slot that the caller drops.
    """
    io = torch.arange(wa.shape[0], device=wa.device)
    ra = io + torch.clamp(torch.searchsorted(wb, wa, side="left"), max=valid_b)
    rb = io + torch.clamp(torch.searchsorted(wa, wb, side="right"), max=valid_a)
    ra = torch.where(io < valid_a, torch.clamp(ra, max=out_len), out_len)
    rb = torch.where(io < valid_b, torch.clamp(rb, max=out_len), out_len)
    return ra, rb


def _segments(na: int, nb: int, segment: int) -> int:
    if segment < 1:
        raise ValueError(f"segment must be >= 1, got {segment}")
    return -(-(na + nb) // segment)  # the last segment may be short


def _window(x: torch.Tensor, off: int, segment: int, fill) -> torch.Tensor:
    """``x[off:off + segment]``, padded with ``fill`` past the end of ``x``."""
    w = x[off : off + segment]
    if w.shape[0] == segment:
        return w
    return torch.cat([w, torch.full((segment - w.shape[0],), fill, dtype=x.dtype, device=x.device)])


def segmented_merge(a: torch.Tensor, b: torch.Tensor, segment: int) -> torch.Tensor:
    """SPM: merge sorted ``a`` and ``b`` in output segments of ``segment``.

    Stable with A-priority; ``|A| + |B|`` may be any size.
    """
    na, nb = a.shape[0], b.shape[0]
    num_seg = _segments(na, nb, segment)
    dtype = result_type(a.dtype, b.dtype)
    sent = max_sentinel(dtype)
    a, b = a.to(dtype), b.to(dtype)
    out = torch.empty((num_seg, segment), dtype=dtype, device=a.device)
    a_off = b_off = 0
    for s in range(num_seg):
        wa, wb = _window(a, a_off, segment, sent), _window(b, b_off, segment, sent)
        ra, rb = _masked_window_ranks(wa, wb, min(na - a_off, segment), min(nb - b_off, segment), segment)
        seg = torch.zeros(segment + 1, dtype=dtype, device=a.device)
        out[s] = seg.scatter_(0, ra, wa).scatter_(0, rb, wb)[:segment]
        # the valid elements ranked inside this segment are the ones it consumed (Theorem 17)
        a_off += int((ra < segment).sum())
        b_off += int((rb < segment).sum())
    return out.reshape(-1)[: na + nb]


def segmented_merge_kv(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, segment: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value SPM (stable, A-priority), for any ``|A| + |B|``.

    Pads are excluded from the ranks by window length, so a pad never
    shadows a real ``+inf`` / ``iinfo.max`` key and leaks its zero value.
    """
    na, nb = ak.shape[0], bk.shape[0]
    num_seg = _segments(na, nb, segment)
    kd = result_type(ak.dtype, bk.dtype)
    vd = result_type(av.dtype, bv.dtype)
    sent = max_sentinel(kd)
    ak, bk, av, bv = ak.to(kd), bk.to(kd), av.to(vd), bv.to(vd)
    ko = torch.empty((num_seg, segment), dtype=kd, device=ak.device)
    vo = torch.empty((num_seg, segment), dtype=vd, device=ak.device)
    a_off = b_off = 0
    for s in range(num_seg):
        wak, wbk = _window(ak, a_off, segment, sent), _window(bk, b_off, segment, sent)
        wav, wbv = _window(av, a_off, segment, 0), _window(bv, b_off, segment, 0)
        ra, rb = _masked_window_ranks(wak, wbk, min(na - a_off, segment), min(nb - b_off, segment), segment)
        seg_k = torch.zeros(segment + 1, dtype=kd, device=ak.device)
        seg_v = torch.zeros(segment + 1, dtype=vd, device=ak.device)
        ko[s] = seg_k.scatter_(0, ra, wak).scatter_(0, rb, wbk)[:segment]
        vo[s] = seg_v.scatter_(0, ra, wav).scatter_(0, rb, wbv)[:segment]
        a_off += int((ra < segment).sum())
        b_off += int((rb < segment).sum())
    return ko.reshape(-1)[: na + nb], vo.reshape(-1)[: na + nb]
