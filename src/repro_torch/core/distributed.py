"""Distributed Merge Path on ``torch.distributed``: the paper's partition over ranks.

The PyTorch counterpart of the reference's ``repro.core.distributed``.  The
paper partitions one merge across p cores that share a cache; here the
cores are the ranks of a process group, the partition math is the same,
and the shared cache is replaced by collectives.  Every primitive has two
exchanges:

* ``exchange="window"`` (default): Algorithm 2's diagonal bisection runs
  collectively.  Every rank runs the same search, and each probe of a
  remote element is one ``all_reduce(SUM)`` to which only the owning rank
  contributes, so every rank ends with the same cut table ``a_cuts[k] =
  intersection(k * seg)``.  By Corollary 7, rank ``i``'s output segment
  consumes exactly ``A[a_cuts[i]:a_cuts[i+1]]`` and
  ``B[b_cuts[i]:b_cuts[i+1]]``, so one ``all_to_all_single`` of
  per-(sender, receiver) pieces moves each element once.  Pieces ride in
  rows padded to the max-piece bound of :func:`window_bounds`, and the
  merge is the length-masked rank merge, so sentinel-valued payloads are
  exact.
* ``exchange="gather"``: every rank gathers both inputs and slices its
  windows.  It moves each element ``P - 1`` times and is the
  bit-exactness oracle of the window exchange.

The API is torch.distributed's single-program form.  Every rank calls a
function with its own contiguous shard and gets back its own output
segment.  Shards follow the ceil-div partition (rank ``i`` holds
``[i * m, min((i + 1) * m, n))`` with ``m = ceil(n / P)``), so the last
shards may be short.  One ``all_gather`` of the shard lengths gives the
global lengths and checks that the shards form that partition.
``group=None`` is the world group; ``P`` is its size.  Tensors stay on the
rank's device, and the backend decides which device is legal: a CUDA
tensor on a gloo group, or a CPU tensor on an NCCL group, raises.  Data
never passes through host memory; only the shard lengths are read there.

Primitives:

* :func:`distributed_merge`, :func:`distributed_merge_kv` and their
  ``*_batched`` forms: each rank returns its ``ceil(n / P)`` slice of the
  merged output (the last slices may be short);
* :func:`distributed_sort`: the one-round sample sort.  A local sort
  (``local_sort="kernel"``: :func:`repro_torch.kernels.ops.sort`, S1 and
  K3 or K4 on a CUDA shard), splitters from a ``P * P`` sample, one
  ``all_to_all`` of the buckets, and a local combine of the ``P`` received
  runs: ``combine="onepass"`` the multiway co-rank pass, ``"tournament"``
  the pairwise rounds (on K7 with ``local_sort="kernel"``);
* :func:`distributed_topk` and :func:`distributed_topk_batched`: per-shard
  top-k, then a ``log2 P``-round butterfly (``exchange="butterfly"``,
  power-of-two ``P``) or an ``all_gather`` of the candidate runs.

Every public wrapper but the ``_local`` forms is guarded
(:func:`repro_torch.runtime.resilience.guarded_call`) and always verifies,
as the reference's are.  A call has one attempt, labelled with the
requested exchange, except :func:`distributed_sort`, whose ``sample``
attempt is followed by ``capacity-2x``: the same sample sort on the same
kernels at twice the capacity factor.  The reference's ``core-resort`` and
``core-topk`` edges are not ported: a failure raises.  The verifier is
collective: each rank checks its own slice on its device, one
``all_gather`` of every rank's (count, input length, first and last
total-order key) checks the rank boundaries and that the counts sum to
the input's length, and one ``all_reduce(MAX)`` of the failure flags gives
every rank the same verdict, so all raise together and none waits in a
collective.  Integer keys whose dtype a backend lacks (int16: neither gloo
nor NCCL has it) are probed in int32 and moved as bytes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.runtime import faults as _faults
from repro_torch.runtime import resilience as _res
from repro_torch.telemetry.spans import get_telemetry

from .batched import (
    _mask_rows,
    _ragged_ranks,
    diagonal_intersections_batched,
    merge_k,
    merge_k_kv,
    merge_k_onepass,
    merge_kv_batched,
    topk_batched,
)
from .merge_path import (bisect, bisect_steps, diagonal_intersections, flip_desc, max_sentinel, merge_sort,
                         result_type, total_order_keys)
from .segmented import _masked_window_ranks

__all__ = [
    "window_bounds",
    "exchange_bytes",
    "distributed_merge",
    "distributed_merge_kv",
    "distributed_merge_batched",
    "distributed_merge_kv_batched",
    "distributed_merge_local",
    "distributed_sort",
    "distributed_sort_local",
    "distributed_topk",
    "distributed_topk_batched",
    "distributed_topk_local",
]

# Dtypes that gloo and NCCL lack: collectives move them as their bytes
# (probes widen them to int32 instead, see _all_reduce_sum).
_BYTE_VIEW = (torch.int16,)


# ---------------------------------------------------------------------------
# window partition math
# ---------------------------------------------------------------------------


def window_bounds(na: int, nb: int, p: int) -> Tuple[int, int, int, int, int]:
    """Static bounds of the window exchange: ``(seg, W_a, W_b, w_a, w_b)``.

    ``seg`` is the per-rank output segment (ceil-div, Corollary 7).
    ``W_a``/``W_b`` bound any rank's A/B window: a ``seg``-output segment
    consumes at most ``seg`` consecutive elements of each input (Lemma 16),
    and never more than the whole input.  ``w_a``/``w_b`` bound any single
    (sender, receiver) piece: the overlap of one sender's contiguous shard
    (``ceil(n / p)`` elements) with one receiver's window.
    """
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    n = na + nb
    seg = -(-n // p)
    m_a = -(-na // p) if na else 0
    m_b = -(-nb // p) if nb else 0
    W_a = max(1, min(na, seg))
    W_b = max(1, min(nb, seg))
    w_a = max(1, min(m_a, W_a))
    w_b = max(1, min(m_b, W_b))
    return seg, W_a, W_b, w_a, w_b


def exchange_bytes(na: int, nb: int, p: int, itemsize: int, kv: bool = False, rows: int = 1) -> dict:
    """Per-rank element bytes moved by each exchange (analytic).

    ``gather``: every rank receives the other ``p - 1`` shards of both
    inputs (and both value arrays when ``kv``).  ``window_payload``: each
    rank receives exactly its output segment's windows (``seg`` elements)
    plus the collective bisection's probes (``2 * bisect_steps`` reductions
    of a ``(rows, p + 1)`` buffer).  ``window_wire_padded``: what the dense
    ``all_to_all`` ships with pieces padded to the max-piece bound.  All
    data terms scale linearly in ``rows``.
    """
    seg, W_a, W_b, w_a, w_b = window_bounds(na, nb, p)
    m_a = -(-na // p) if na else 0
    m_b = -(-nb // p) if nb else 0
    nval = (2 if kv else 1) * rows
    gather = (p - 1) * (m_a + m_b) * itemsize * nval
    probes = 2 * bisect_steps(min(na, nb)) * rows * (p + 1) * itemsize
    payload = seg * itemsize * nval + probes
    wire = p * (w_a + w_b) * itemsize * nval + probes
    return {
        "gather": gather,
        "window_payload": payload,
        "window_wire_padded": wire,
        "seg": seg,
        "max_window": (W_a, W_b),
        "max_piece": (w_a, w_b),
    }


# ---------------------------------------------------------------------------
# collectives on the group's backend
# ---------------------------------------------------------------------------


def _check_device(group, *tensors: torch.Tensor) -> None:
    """Raise unless the group's backend takes the tensors' device (gloo: CPU,
    NCCL: CUDA)."""
    backend = str(dist.get_backend(group))
    for t in tensors:
        if t is None:
            continue
        ok = "nccl" in backend if t.is_cuda else "gloo" in backend
        if not ok:
            raise ValueError(f"a {t.device.type} tensor cannot ride a {backend} process group")


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives move it: contiguous, and as bytes (last axis
    doubled) for a dtype the backends lack."""
    x = x.contiguous()
    return x.view(torch.uint8) if x.dtype in _BYTE_VIEW else x


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` of a ``(p, ...)`` tensor: row ``j`` goes to rank
    ``j``, and row ``j`` of the result came from rank ``j``."""
    send = _wire(x)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.view(x.dtype) if recv.dtype != x.dtype else recv


def _all_gather(x: torch.Tensor, p: int, group) -> torch.Tensor:
    """Every rank's ``x`` stacked: ``(p, *x.shape)``."""
    send = _wire(x)
    out = torch.empty((p * send.shape[0],) + tuple(send.shape[1:]), dtype=send.dtype, device=send.device)
    # all_gather_single is all_gather_into_tensor's newer name; gloo takes only
    # the concatenation along dim 0
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, send, group=group)
    out = out.view((p,) + tuple(send.shape))
    return out.view(x.dtype) if out.dtype != x.dtype else out


def _all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """SUM over the group, an int16 tensor in int32 and cast back (exact
    where only one rank contributes a nonzero value)."""
    y = x.to(torch.int32) if x.dtype in _BYTE_VIEW else x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y.to(x.dtype)


def _shard_lengths(group, p: int, device, rows: int = 1, **lengths: int) -> dict:
    """The global lengths from one ``all_gather`` of the shard lengths.

    Each keyword is one array's local length, which must be this rank's
    ceil-div shard of the global length (``[i * m, min((i + 1) * m, n))``,
    ``m = ceil(n / p)``); ``rows`` must be the same on every rank.
    Otherwise every rank raises the same ``ValueError``.
    """
    local = torch.tensor([rows, *lengths.values()], dtype=torch.int64, device=device)
    table = _all_gather(local, p, group).tolist()  # (p, 1 + len(lengths)): the only host read
    if any(row[0] != rows for row in table):
        raise ValueError(f"every rank must hold the same rows, got {[row[0] for row in table]}")
    out = {}
    for j, name in enumerate(lengths, start=1):
        got = [row[j] for row in table]
        n = sum(got)
        m = -(-n // p)
        want = [min(max(n - i * m, 0), m) for i in range(p)]
        if got != want:
            raise ValueError(f"{name}: shard lengths {got} over {p} ranks, want the ceil-div partition {want}")
        out[name] = n
    return out


def _group_info(group) -> Tuple[int, int]:
    """``(P, this rank's index in the group)``."""
    return dist.get_world_size(group), dist.get_rank(group)


# ---------------------------------------------------------------------------
# collective diagonal intersections (Algorithm 2 over the group)
# ---------------------------------------------------------------------------


def _collective_intersections(
    a_sh: torch.Tensor, b_sh: torch.Tensor, diags: torch.Tensor, na: int, nb: int, group, idx: int
) -> torch.Tensor:
    """Algorithm 2's diagonal bisection with collective memory probes.

    ``a_sh``/``b_sh`` are this rank's contiguous ``(R, m)`` shards of the
    global ``(R, na)``/``(R, nb)`` sorted rows; ``diags`` is ``(D,)``.  The
    bisection state is the same on every rank, and each probe of ``A[g]``
    or ``B[g]`` is one ``all_reduce(SUM)`` of an ``(R, D)`` buffer to which
    only the owning rank contributes: ``2 * bisect_steps(min(na, nb))``
    reductions in all.  Returns the ``(R, D)`` int32 a-side cuts.
    """
    r, m_a = a_sh.shape
    m_b = b_sh.shape[1]
    dg = diags[None, :].expand(r, diags.shape[0])
    if na == 0 or nb == 0:
        return torch.clamp(dg, max=na)

    def fetch(shard, g, m):
        own = g // m
        loc = torch.clamp(g - own * m, 0, m - 1)
        v = torch.gather(shard, 1, loc.long())
        return _all_reduce_sum(torch.where(own == idx, v, torch.zeros((), dtype=v.dtype, device=v.device)), group)

    def probe(mid):  # A-priority: A[i] precedes B[j] iff A[i] <= B[j]
        av = fetch(a_sh, torch.clamp(mid, 0, na - 1), m_a)
        bv = fetch(b_sh, torch.clamp(dg - 1 - mid, 0, nb - 1), m_b)
        return av <= bv

    lo = torch.clamp(dg - nb, min=0)
    hi = torch.clamp(dg, max=na)
    return bisect(lo, hi, bisect_steps(min(na, nb)), probe)


# ---------------------------------------------------------------------------
# the window exchange (one all_to_all, each element moves once)
# ---------------------------------------------------------------------------


def _exchange_windows(shards, cuts: torch.Tensor, w_piece: int, W: int, p: int, group, idx: int):
    """Move each rank's exact input window to it with one ``all_to_all_single``.

    The cut table partitions the global index space into ``p`` consecutive
    receiver windows ``[cuts[i], cuts[i+1])``.  Sender ``j`` slices, for
    every receiver ``i``, the overlap of its shard ``[j*m, (j+1)*m)`` with
    window ``i`` into row ``i`` of a ``(p, R, w_piece)`` buffer, so each
    element is sent once.  The receiver recomputes the piece lengths from
    the replicated cut table (no extra collective) and scatters the pieces
    at their running offsets into an ``(R, W + 1)`` buffer filled with
    ``fill``, whose last column takes the padding and is dropped.

    ``shards`` is a sequence of ``((R, m) shard, fill)`` sharing the cuts.
    Returns ``(windows, wlen)``: one ``(R, W)`` buffer per shard and the
    ``(R,)`` window lengths.
    """
    r, m = shards[0][0].shape
    dev = cuts.device
    my_lo = idx * m
    start_loc = torch.clamp(torch.clamp(cuts[:, :-1], min=my_lo) - my_lo, 0, m)  # (R, p) piece starts in my shard
    piece = torch.arange(w_piece, dtype=torch.int32, device=dev)
    gcols = (start_loc.T[:, :, None] + piece).long()  # (p, R, w_piece)

    c0, c1 = cuts[:, idx], cuts[:, idx + 1]
    wlen = c1 - c0
    j_lo = torch.arange(p, dtype=torch.int32, device=dev)[None, :] * m  # (1, p) sender shard starts
    cnt = torch.clamp(torch.minimum(c1[:, None], j_lo + m) - torch.maximum(c0[:, None], j_lo), 0, m)  # (R, p)
    offs = torch.cumsum(cnt, dim=1) - cnt
    pos = torch.where(piece < cnt.T[:, :, None], offs.T[:, :, None] + piece, W)  # (p, R, w_piece)
    pos = pos.permute(1, 0, 2).reshape(r, p * w_piece).long()

    windows = []
    for shard, fill in shards:
        padded = torch.cat([shard, torch.full((r, w_piece), fill, dtype=shard.dtype, device=dev)], dim=1)
        send = torch.gather(padded[None].expand(p, r, m + w_piece), 2, gcols)
        recv = _all_to_all(send, group)  # (p, R, w_piece): sender j's piece for me
        win = torch.full((r, W + 1), fill, dtype=shard.dtype, device=dev)
        win.scatter_(1, pos, recv.permute(1, 0, 2).reshape(r, p * w_piece))
        windows.append(win[:, :W])
    return windows, wlen


# ---------------------------------------------------------------------------
# distributed merge (keys only and key-value, 1-D and batched)
# ---------------------------------------------------------------------------


def _segment_from_windows(wa, wb, alen, blen, seg: int, va=None, vb=None):
    """Merge two fill-padded ragged windows into this rank's ``(R, seg)`` segment.

    Ranks are length-masked (``_ragged_ranks``), so padding is excluded by
    count and payload keys equal to the sentinel merge exactly.  The
    windows are exactly the segment's inputs, so ``alen + blen <= seg``:
    every valid rank lands inside the segment, and the pads (rank ``W_a +
    W_b >= seg``) go to one extra column that is dropped.
    """
    ra, rb = _ragged_ranks(wa, wb, alen, blen)
    ra, rb = torch.clamp(ra, max=seg), torch.clamp(rb, max=seg)
    r = wa.shape[0]
    keys = torch.full((r, seg + 1), max_sentinel(wa.dtype), dtype=wa.dtype, device=wa.device)
    keys = keys.scatter_(1, ra, wa).scatter_(1, rb, wb)[:, :seg]
    if va is None:
        return keys, None
    vals = torch.zeros((r, seg + 1), dtype=va.dtype, device=va.device)
    vals = vals.scatter_(1, ra, va).scatter_(1, rb, vb)[:, :seg]
    return keys, vals


def _take_window(full: torch.Tensor, start: torch.Tensor, W: int, fill) -> torch.Tensor:
    """Row ``r`` of the result is ``full[r, start[r]:start[r] + W]``, padded
    with ``fill`` past the end."""
    fp = torch.cat([full, torch.full((full.shape[0], W), fill, dtype=full.dtype, device=full.device)], dim=1)
    cols = start[:, None].long() + torch.arange(W, device=full.device)[None, :]
    return torch.gather(fp, 1, cols)


def _merge_local_body(ak_sh, av_sh, bk_sh, bv_sh, *, group, na: int, nb: int, p: int, exchange: str):
    """Per-rank body shared by every distributed merge.

    Shards are ``(R, m)`` (``R = 1`` for the 1-D forms), the last ones
    sentinel-padded past the true ``na``/``nb``.  Returns this rank's
    ``(R, seg)`` output segment (keys, values or None), sentinel-padded
    past ``na + nb``.
    """
    idx = dist.get_rank(group)
    n = na + nb
    seg, W_a, W_b, w_a, w_b = window_bounds(na, nb, p)
    kv = av_sh is not None
    sent = max_sentinel(ak_sh.dtype)
    dev = ak_sh.device

    if exchange == "gather":
        a_full = _all_gather(ak_sh, p, group).permute(1, 0, 2).reshape(ak_sh.shape[0], -1)[:, :na]
        b_full = _all_gather(bk_sh, p, group).permute(1, 0, 2).reshape(bk_sh.shape[0], -1)[:, :nb]
        d0 = min(idx * seg, n)
        d1 = min(d0 + seg, n)
        dg = torch.tensor([d0, d1], dtype=torch.int32, device=dev)
        cuts2 = diagonal_intersections_batched(a_full, b_full, dg)  # (R, 2)
        a0, alen = cuts2[:, 0], cuts2[:, 1] - cuts2[:, 0]
        b0, blen = d0 - cuts2[:, 0], (d1 - d0) - alen
        wa = _mask_rows(_take_window(a_full, a0, W_a, sent), alen, sent)
        wb = _mask_rows(_take_window(b_full, b0, W_b, sent), blen, sent)
        va = vb = None
        if kv:
            av_f = _all_gather(av_sh, p, group).permute(1, 0, 2).reshape(av_sh.shape[0], -1)[:, :na]
            bv_f = _all_gather(bv_sh, p, group).permute(1, 0, 2).reshape(bv_sh.shape[0], -1)[:, :nb]
            va = _mask_rows(_take_window(av_f, a0, W_a, 0), alen, 0)
            vb = _mask_rows(_take_window(bv_f, b0, W_b, 0), blen, 0)
        return _segment_from_windows(wa, wb, alen, blen, seg, va, vb)

    if exchange != "window":
        raise ValueError(f"exchange must be 'window' or 'gather', got {exchange!r}")
    diags = torch.as_tensor(np.minimum(np.arange(p + 1) * seg, n), dtype=torch.int32, device=dev)
    a_cuts = _collective_intersections(ak_sh, bk_sh, diags, na, nb, group, idx)
    b_cuts = diags[None, :] - a_cuts
    a_shards = [(ak_sh, sent)] + ([(av_sh, 0)] if kv else [])
    b_shards = [(bk_sh, sent)] + ([(bv_sh, 0)] if kv else [])
    a_wins, alen = _exchange_windows(a_shards, a_cuts, w_a, W_a, p, group, idx)
    b_wins, blen = _exchange_windows(b_shards, b_cuts, w_b, W_b, p, group, idx)
    va = a_wins[1] if kv else None
    vb = b_wins[1] if kv else None
    return _segment_from_windows(a_wins[0], b_wins[0], alen, blen, seg, va, vb)


def _pad_shardable(x: torch.Tensor, m: int, fill) -> torch.Tensor:
    """Pad the last axis of a shard up to the full shard length ``m`` with ``fill``."""
    short = m - x.shape[-1]
    if short == 0:
        return x
    return torch.cat([x, torch.full(x.shape[:-1] + (short,), fill, dtype=x.dtype, device=x.device)], dim=-1)


def _record_merge_telemetry(na: int, nb: int, p: int, itemsize: int, kv: bool, rows: int) -> None:
    """Record the Corollary 7 load-balance metrics of one merge.

    Counters: per-rank window sizes (``distributed.window_elems.dev*``) and
    the accumulated analytic exchange bytes; gauges: the per-call bytes of
    each exchange and ``distributed.balance_ratio``, max/min of the nonzero
    per-rank window totals.  A rank's A and B windows together hold its
    output segment (Corollary 7), so the totals need no cut: every rank
    records the same values.
    """
    if na == 0 or nb == 0:
        return
    info = exchange_bytes(na, nb, p, itemsize, kv=kv, rows=rows)
    tel = get_telemetry()
    tel.counter("distributed.exchange_calls").add(1)
    for flavor in ("gather", "window_payload", "window_wire_padded"):
        tel.counter(f"distributed.exchange_bytes.{flavor}").add(info[flavor])
        tel.gauge(f"distributed.exchange_bytes.{flavor}").set(info[flavor])
    diags = np.minimum(np.arange(p + 1, dtype=np.int64) * info["seg"], na + nb)
    win = rows * np.diff(diags)
    for d in range(p):
        tel.counter(f"distributed.window_elems.dev{d}").add(int(win[d]))
    nz = win[win > 0]
    tel.gauge("distributed.balance_ratio").set(float(nz.max() / nz.min()) if nz.size >= 2 else 1.0)


def _merge_lengths(ak, av, bk, bv, group, exchange: str) -> Tuple[int, int]:
    """Check a distributed merge's arguments and partition (a ``ValueError``
    on every rank otherwise); return the global ``(na, nb)``."""
    if exchange not in ("window", "gather"):
        raise ValueError(f"exchange must be 'window' or 'gather', got {exchange!r}")
    if av is not None and (av.shape != ak.shape or bv.shape != bk.shape):
        raise ValueError(f"value shapes must match key shapes: keys {tuple(ak.shape)}/{tuple(bk.shape)}, "
                         f"values {tuple(av.shape)}/{tuple(bv.shape)}")
    _check_device(group, ak, av, bk, bv)
    p, _ = _group_info(group)
    rows = ak.shape[0]
    if bk.shape[0] != rows:
        raise ValueError(f"batch mismatch: {tuple(ak.shape)} vs {tuple(bk.shape)}")
    lens = _shard_lengths(group, p, ak.device, rows=rows, na=ak.shape[-1], nb=bk.shape[-1])
    return lens["na"], lens["nb"]


def _distributed_merge_impl(ak, av, bk, bv, group, exchange: str, na: int, nb: int):
    """Pad this rank's shards to equal length, run the body, and trim the
    segment to this rank's slice (the arguments already through
    :func:`_merge_lengths`).

    Shards are ``(R, na_i)`` / ``(R, nb_i)`` (values may be None); the
    result is this rank's ``(R, len_i)`` slice of the ``(R, na + nb)``
    merge, ``len_i`` the ceil-div partition of ``na + nb``.
    """
    kv = av is not None
    p, idx = _group_info(group)
    rows = ak.shape[0]
    kd = result_type(ak.dtype, bk.dtype)
    ak, bk = ak.to(kd), bk.to(kd)
    if kv:
        vd = result_type(av.dtype, bv.dtype)
        av, bv = av.to(vd), bv.to(vd)
    if na == 0 or nb == 0:  # the merge is the other input, already in this rank's slice
        return (bk, bv) if na == 0 else (ak, av)
    sent = max_sentinel(kd)
    m_a, m_b = -(-na // p), -(-nb // p)
    ak, bk = _pad_shardable(ak, m_a, sent), _pad_shardable(bk, m_b, sent)
    if kv:
        av, bv = _pad_shardable(av, m_a, 0), _pad_shardable(bv, m_b, 0)
    keys, vals = _merge_local_body(ak, av, bk, bv, group=group, na=na, nb=nb, p=p, exchange=exchange)
    n = na + nb
    seg = -(-n // p)
    mine = min(max(n - idx * seg, 0), seg)
    _record_merge_telemetry(na, nb, p, torch.empty((), dtype=kd).element_size(), kv, rows)
    return keys[:, :mine], (vals[:, :mine] if kv else None)


def _group_verdict(keys: torch.Tensor, lens: torch.Tensor, in_len: int, group, *, overflow=None,
                   replicated: bool = False, descending: bool = False) -> Optional[str]:
    """The verdict, the same on every rank, on this rank's ``(R, L)`` output
    ``keys``, of which row ``r``'s first ``lens[r]`` are valid.

    Each rank checks its own valid prefixes on its device.  Unless the
    output is ``replicated`` (a top-k), one ``all_gather`` of every rank's
    (count, first and last total-order key) per row and its input length
    ``in_len`` checks that the rank boundaries keep the order and that the
    counts sum to the input's length.  One ``all_reduce(MAX)`` of the four
    failure flags (with ``overflow``, a 0-d bool tensor) ends it, and one
    host read.
    """
    p, _ = _group_info(group)
    keys = keys if keys.ndim == 2 else keys[None, :]
    lens = lens.to(torch.int64).reshape(-1)
    bad = torch.zeros(4, dtype=torch.int32, device=keys.device)
    bad[0] = ~_res.keys_ordered(keys, lens, descending=descending)
    if not replicated:
        rows, width = keys.shape
        tok = total_order_keys(keys).to(torch.int64)
        ends = torch.zeros((rows, 2), dtype=torch.int64, device=keys.device)
        if width:
            ends = torch.stack([tok[:, 0], tok.gather(1, (lens - 1).clamp(0, width - 1)[:, None])[:, 0]], 1)
        in_lens = torch.full((rows, 1), in_len, dtype=torch.int64, device=keys.device)
        table = _all_gather(torch.cat([lens[:, None], ends, in_lens], 1), p, group)  # (p, R, 4)
        prev = torch.zeros(rows, dtype=torch.int64, device=keys.device)
        seen = torch.zeros(rows, dtype=torch.bool, device=keys.device)
        for r in range(p):
            count, first, last = table[r, :, 0], table[r, :, 1], table[r, :, 2]
            here = count > 0
            bad[1] |= (seen & here & (prev > first)).any().to(torch.int32)
            prev, seen = torch.where(here, last, prev), seen | here
        bad[2] = (table[:, :, 0].sum(0) != table[:, :, 3].sum(0)).any()
    if overflow is not None:
        bad[3] = overflow
    dist.all_reduce(bad, op=dist.ReduceOp.MAX, group=group)
    what = ("a rank's output is not in order", "two ranks' outputs are out of order across their boundary",
            "the valid counts do not sum to the input's length", "bucket overflow (capacity exceeded)")
    return "; ".join(msg for flag, msg in zip(bad.tolist(), what) if flag) or None


def _guarded_merge(op: str, ak, av, bk, bv, group, exchange: str):
    """One distributed merge through the guard: the requested exchange as
    its one attempt, always verified.  Steps aside (the exchange runs
    directly) where the guard does."""
    na, nb = _merge_lengths(ak, av, bk, bv, group, exchange)
    if not _res.guard_enabled() or _res.is_tracing():
        return _distributed_merge_impl(ak, av, bk, bv, group, exchange, na, nb)
    idx = _faults.next_index(op)
    if av is None:
        ak, bk = _faults.maybe_nan_lace(op, idx, (ak, bk), (0, 1))
    else:
        ak, av, bk, bv = _faults.maybe_nan_lace(op, idx, (ak, av, bk, bv), (0, 2))
    in_len = ak.shape[-1] + bk.shape[-1]

    def verify(out):
        keys = out[0]
        return _group_verdict(keys, torch.full((keys.shape[0],), keys.shape[1], device=keys.device), in_len, group)

    return _res.guarded_call(op, [(exchange, lambda: _distributed_merge_impl(ak, av, bk, bv, group, exchange, na, nb))],
                             index=idx, verifier=verify, verify=True)


def distributed_merge(a: torch.Tensor, b: torch.Tensor, group=None, exchange: str = "window") -> torch.Tensor:
    """Merge two sorted arrays sharded over a process group.

    Each rank passes its contiguous shards of ``A`` and ``B`` and returns
    its ``ceil((|A| + |B|) / P)`` slice of the stable A-priority merge.
    ``exchange="window"`` moves each element once; ``"gather"`` is the
    all-gather oracle, bit-identical to it.  Guarded: a failed exchange
    raises ``GuardedDispatchError``, an output out of order (unsorted or
    NaN-laced inputs) ``VerificationError``, on every rank.
    """
    keys, _ = _guarded_merge("distributed_merge", a[None, :], None, b[None, :], None, group, exchange)
    return keys[0]


def distributed_merge_kv(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, group=None, exchange: str = "window"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value :func:`distributed_merge`; values ride the same exchange.
    Safe for payload keys equal to the sentinel: ranks are length-masked,
    so a shard pad never shadows a real ``+inf``/``iinfo.max`` key."""
    keys, vals = _guarded_merge("distributed_merge_kv", ak[None, :], av[None, :], bk[None, :], bv[None, :], group,
                                exchange)
    return keys[0], vals[0]


def distributed_merge_batched(a: torch.Tensor, b: torch.Tensor, group=None, exchange: str = "window") -> torch.Tensor:
    """Batched :func:`distributed_merge`: ``(R, na_i) + (R, nb_i)`` shards, the
    merge axis sharded and the rows on every rank.  Every row has its own
    cut table; all rows share the exchanges."""
    keys, _ = _guarded_merge("distributed_merge_batched", a, None, b, None, group, exchange)
    return keys


def distributed_merge_kv_batched(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, group=None, exchange: str = "window"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched :func:`distributed_merge_kv`."""
    return _guarded_merge("distributed_merge_kv_batched", ak, av, bk, bv, group, exchange)


def distributed_merge_local(a_shard: torch.Tensor, b_shard: torch.Tensor, group=None) -> torch.Tensor:
    """Per-rank all-gather merge body (the reference's legacy signature).

    Merges globally sharded sorted A and B through one gather of each and
    returns this rank's ``N / P`` output slice.  ``|A|`` and ``|B|`` must
    be ``P`` equal shards here; :func:`distributed_merge` takes the
    ceil-div partition and offers the window exchange.
    """
    _check_device(group, a_shard, b_shard)
    p, idx = _group_info(group)
    a = _all_gather(a_shard, p, group).reshape(-1)
    b = _all_gather(b_shard, p, group).reshape(-1)
    na, nb = a.shape[0], b.shape[0]
    seg = (na + nb) // p
    dtype = result_type(a.dtype, b.dtype)
    sent = max_sentinel(dtype)
    d0 = torch.tensor([idx * seg], dtype=torch.int32, device=a.device)
    a0 = diagonal_intersections(a, b, d0)[0]
    b0 = d0[0] - a0
    # a T-output segment needs at most T from each input (Lemma 16)
    wa = _take_window(a.to(dtype)[None], a0[None], seg, sent)[0]
    wb = _take_window(b.to(dtype)[None], b0[None], seg, sent)[0]
    valid_a = torch.clamp(na - a0, 0, seg)
    valid_b = torch.clamp(nb - b0, 0, seg)
    ra, rb = _masked_window_ranks(wa, wb, valid_a, valid_b, seg)
    out = torch.full((seg + 1,), sent, dtype=dtype, device=a.device)
    return out.scatter_(0, ra, wa).scatter_(0, rb, wb)[:seg]


# ---------------------------------------------------------------------------
# distributed sample sort
# ---------------------------------------------------------------------------


def _pairwise_tree_merge(runs, lens=None) -> torch.Tensor:
    """Deprecated shim: use :func:`repro_torch.core.batched.merge_k`
    (tournament) or :func:`repro_torch.core.batched.merge_k_onepass`
    directly; :func:`distributed_sort` selects between them by ``combine=``."""
    return merge_k(runs, lens=lens)


def _check_sort_args(local_sort: str, combine: str) -> None:
    if local_sort not in ("core", "kernel"):
        raise ValueError(f"local_sort must be 'core' or 'kernel', got {local_sort!r}")
    if combine not in ("onepass", "tournament"):
        raise ValueError(f"combine must be 'onepass' or 'tournament', got {combine!r}")


def sort_capacity(m: int, capacity_factor: float) -> int:
    """The bucket capacity of a shard of ``m``: ``capacity_factor * m``
    rounded up to a multiple of 128."""
    cap = int(capacity_factor * m)
    return -(-cap // 128) * 128


def sort_prepare(x_shard: torch.Tensor, p: int, local_sort: str = "core") -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-rank work before the splitters: ``(local, samples)``.

    ``local`` is the shard sorted (``"kernel"``:
    :func:`repro_torch.kernels.ops.sort`, S1 and K3 or K4 on a CUDA shard;
    ``"core"``: :func:`repro_torch.core.merge_sort`), ``samples`` its ``p``
    equispaced elements, this rank's splitter candidates.
    """
    if local_sort == "kernel":
        from repro_torch.kernels import ops as kops  # the kernel layer imports the core

        local = kops.sort(x_shard)
    else:
        local = merge_sort(x_shard)
    m = x_shard.shape[0]
    samp = (torch.arange(p, device=x_shard.device) * m) // p
    return local, local[samp]


def sort_splitters(cands: torch.Tensor, p: int) -> torch.Tensor:
    """The ``p - 1`` global splitters from every rank's candidates (``(p * p,)``,
    rank-major): every ``p``-th of them sorted."""
    cands = merge_sort(cands.reshape(-1))
    return cands[torch.arange(1, p, device=cands.device) * p]


def sort_buckets(local: torch.Tensor, splitters: torch.Tensor, cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-rank work after the splitters: ``(send, counts)``.

    Bucket ``k`` of the sorted shard is the run ``[off[k], off[k+1])``,
    with the offsets a left ``searchsorted`` against the splitters.
    ``send`` is ``(p, cap)``: row ``k`` holds bucket ``k``'s first ``cap``
    elements, masked to the sentinel past its count; ``counts`` is the
    ``(p,)`` int32 bucket sizes (a count above ``cap`` is an overflow).
    """
    m = local.shape[0]
    dev = local.device
    offs = torch.searchsorted(local, splitters, side="left").to(torch.int32)
    offs = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), offs, torch.full((1,), m, dtype=torch.int32, device=dev)])
    counts = offs[1:] - offs[:-1]
    sentinel = max_sentinel(local.dtype)
    lp = torch.cat([local, torch.full((cap,), sentinel, dtype=local.dtype, device=dev)])
    pos = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    send = lp[(offs[:-1, None] + pos).long()]
    return torch.where(pos < counts[:, None], send, sentinel), counts


def sort_combine(recv: torch.Tensor, recv_lens: torch.Tensor, combine: str = "onepass",
                 local_sort: str = "core") -> torch.Tensor:
    """Merge the ``p`` received sorted runs (``(p, cap)``, valid lengths
    ``recv_lens``) into this rank's ``(p * cap,)`` bucket, sentinel-padded.

    ``"onepass"``: :func:`repro_torch.core.merge_k_onepass`;
    ``"tournament"``: :func:`repro_torch.kernels.ops.merge_k` (K7 on a CUDA
    tensor, once a pair of runs is wider than a tile) with
    ``local_sort="kernel"``, else :func:`repro_torch.core.merge_k`.
    """
    if combine == "onepass":
        return merge_k_onepass(recv, lens=recv_lens)
    if local_sort == "kernel":
        from repro_torch.kernels import ops as kops

        return kops.merge_k(recv, lens=recv_lens)
    return merge_k(recv, lens=recv_lens)


def distributed_sort_local(
    x_shard: torch.Tensor,
    group=None,
    capacity_factor: float = 2.0,
    local_sort: str = "core",
    combine: str = "onepass",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-rank sample sort body: ``(sorted_padded, count, overflowed)``.

    This rank's output bucket (ascending, sentinel-padded to ``p * cap``),
    its ``(1,)`` int32 count of valid elements, and the group's overflow
    flag (an element dropped anywhere: check it, or retry with a larger
    ``capacity_factor``).  One round of data movement: after the local
    sort and the splitter ``all_gather``, every element crosses the group
    once in the bucket ``all_to_all``; the bucket counts ride a second,
    ``(p,)``-sized one.  Every rank's shard must have the same length.
    """
    _check_sort_args(local_sort, combine)
    _check_device(group, x_shard)
    p, _ = _group_info(group)
    cap = sort_capacity(x_shard.shape[0], capacity_factor)
    local, samples = sort_prepare(x_shard, p, local_sort)
    splitters = sort_splitters(_all_gather(samples, p, group), p)
    send, counts = sort_buckets(local, splitters, cap)
    recv = _all_to_all(send, group)  # (p, cap): the p sorted runs destined for this rank
    recv_lens = _all_to_all(counts, group)  # each sender's bucket count for this rank
    out = sort_combine(recv, recv_lens, combine, local_sort)
    overflow = torch.any(counts > cap).to(torch.int32).reshape(1)
    dist.all_reduce(overflow, op=dist.ReduceOp.MAX, group=group)
    return out, recv_lens.sum().to(torch.int32)[None], overflow[0] > 0


def distributed_sort(
    x: torch.Tensor,
    group=None,
    capacity_factor: float = 2.0,
    local_sort: str = "core",
    combine: str = "onepass",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample-sort a sharded array; see :func:`distributed_sort_local`.

    Each rank passes its shard; the shards must be ``P`` equal parts (the
    bucket capacity is a function of the shard length, and every rank's
    must agree).  The concatenation over ranks of each bucket's first
    ``count`` elements is the sorted array.

    Guarded and verified (:func:`_group_verdict`, the overflow flag
    included): a bucket overflow, an output out of order or counts that do
    not sum to the input's length reject the ``sample`` attempt, and the
    ``capacity-2x`` attempt runs the same sort at ``2 * capacity_factor``,
    so the padded output is then twice as wide.  When that fails too, every
    rank raises (``VerificationError``, or ``GuardedDispatchError`` for a
    failed launch).
    """
    _check_sort_args(local_sort, combine)
    _check_device(group, x)
    p, _ = _group_info(group)
    n = _shard_lengths(group, p, x.device, n=x.shape[0])["n"]
    if n % p or n == 0:
        raise ValueError(f"distributed_sort needs {p} equal nonempty shards, got {n} elements in all")
    if not _res.guard_enabled() or _res.is_tracing():
        return distributed_sort_local(x, group, capacity_factor, local_sort, combine)
    idx = _faults.next_index("distributed_sort")
    (x,) = _faults.maybe_nan_lace("distributed_sort", idx, (x,), (0,))

    def run(cf):
        return lambda: distributed_sort_local(x, group, cf, local_sort, combine)

    def verify(out):
        keys, count, overflow = out
        return _group_verdict(keys, count, x.shape[0], group, overflow=overflow)

    return _res.guarded_call("distributed_sort", [("sample", run(capacity_factor)),
                                                  ("capacity-2x", run(2.0 * capacity_factor))],
                             index=idx, verifier=verify, verify=True)


# ---------------------------------------------------------------------------
# distributed top-k
# ---------------------------------------------------------------------------


def _butterfly_topk_combine(lk, lv, k: int, p: int, group, idx: int):
    """``log2 P``-round butterfly combine of per-rank candidate runs.

    ``lk``/``lv`` are this rank's ``(R, k)`` ascending flipped keys and
    value rows.  Round ``r`` swaps candidates with partner ``idx ^ 2^r``
    (one ``batch_isend_irecv`` pair) and keeps the first ``k`` of the
    pairwise merge.  The lower rank of each pair is the A side, so the
    bracket, and every tie-break, is the gather path's adjacent-pairs tree.
    """
    for r in range(p.bit_length() - 1):  # p is a power of two
        partner = idx ^ (1 << r)
        peer = partner if group is None else dist.get_global_rank(group, partner)
        mine = [_wire(lk), _wire(lv)]
        theirs = [torch.empty_like(t) for t in mine]
        ops = [dist.P2POp(dist.isend, t, peer, group) for t in mine]
        ops += [dist.P2POp(dist.irecv, t, peer, group) for t in theirs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ok, ov = theirs[0].view(lk.dtype), theirs[1].view(lv.dtype)
        low = (idx & (1 << r)) == 0
        mk, mv = merge_kv_batched(lk, lv, ok, ov) if low else merge_kv_batched(ok, ov, lk, lv)
        lk, lv = mk[:, :k].contiguous(), mv[:, :k].contiguous()
    return lk, lv


def _topk_local_body(x_shard, *, k: int, group, p: int, exchange: str, batched: bool, offset: Optional[int] = None):
    """Per-rank body of the 1-D and batched distributed top-k.

    ``offset`` is the global index of this rank's first element (default
    ``rank * m``, the equal-shard layout).  The result is the same on
    every rank.
    """
    idx = dist.get_rank(group)
    xb = x_shard if batched else x_shard[None, :]
    r, m = xb.shape
    idx0 = idx * m if offset is None else offset
    lv, li = topk_batched(xb, k)
    li = li.to(torch.int32) + idx0
    lk = flip_desc(lv)  # ascending keys; exact for ints at iinfo.min
    if exchange == "butterfly":
        gk, gv = _butterfly_topk_combine(lk, li, k, p, group, idx)
    elif exchange == "gather":
        # merge the gathered runs on order-flipped keys (ascending merge =
        # descending values); merge_k_kv excludes its pad slots by length
        keys, idxs = _all_gather(lk, p, group), _all_gather(li, p, group)  # (P, R, k)
        rows = [merge_k_kv(keys[:, i], idxs[:, i]) for i in range(r)]
        gk = torch.stack([mk[:k] for mk, _ in rows])
        gv = torch.stack([mv[:k] for _, mv in rows])
    else:
        raise ValueError(f"exchange must be 'butterfly' or 'gather', got {exchange!r}")
    vals = flip_desc(gk)
    return (vals, gv) if batched else (vals[0], gv[0])


def _resolve_topk_exchange(exchange: str, p: int) -> str:
    if exchange == "auto":
        return "butterfly" if p >= 2 and (p & (p - 1)) == 0 else "gather"
    if exchange == "butterfly" and (p < 2 or (p & (p - 1)) != 0):
        raise ValueError(f"butterfly combine needs a power-of-two group, got P={p}")
    if exchange not in ("butterfly", "gather"):
        raise ValueError(f"exchange must be 'auto', 'butterfly' or 'gather', got {exchange!r}")
    return exchange


def distributed_topk_local(x_shard: torch.Tensor, k: int, group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank body (the reference's legacy signature): the global
    (values, indices) top-k of a vector in ``P`` equal shards, by the gather
    combine.  Indices are global; the result is the same on every rank."""
    _check_device(group, x_shard)
    p, _ = _group_info(group)
    return _topk_local_body(x_shard, k=k, group=group, p=p, exchange="gather", batched=False)


def _distributed_topk(x: torch.Tensor, k: int, group, exchange: str, batched: bool):
    _check_device(group, x)
    p, idx = _group_info(group)
    exchange = _resolve_topk_exchange(exchange, p)
    rows = x.shape[0] if batched else 1
    v = _shard_lengths(group, p, x.device, rows=rows, v=x.shape[-1])["v"]
    m = -(-v // p)
    if min(v - (p - 1) * m, m) < k:  # the last shard is the shortest
        raise ValueError(f"every shard must hold at least k={k} elements: {v} over {p} ranks")

    def run(x):
        return lambda: _topk_local_body(x, k=k, group=group, p=p, exchange=exchange, batched=batched, offset=idx * m)

    if not _res.guard_enabled() or _res.is_tracing():
        return run(x)()
    op = "distributed_topk_batched" if batched else "distributed_topk"
    index = _faults.next_index(op)
    (x,) = _faults.maybe_nan_lace(op, index, (x,), (0,))

    def verify(out):
        vals, ids = out
        ids = ids if ids.ndim == 2 else ids[None, :]
        return _group_verdict(vals, (ids >= 0).sum(1), x.shape[-1], group, replicated=True, descending=True)

    return _res.guarded_call(op, [(exchange, run(x))], index=index, verifier=verify, verify=True)


def distributed_topk(x: torch.Tensor, k: int, group=None, exchange: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Global (values, int32 indices) top-k of a sharded vector, the same on every rank.

    ``exchange="auto"`` takes the butterfly (``k * log2 P`` candidates moved
    per rank) when ``P`` is a power of two, else the ``all_gather`` tree
    (``P * k``).  Both are bit-identical: same bracket, same tie-breaks
    (the smallest global index first).  Every shard must hold at least
    ``k`` elements.
    """
    return _distributed_topk(x, k, group, exchange, batched=False)


def distributed_topk_batched(
    x: torch.Tensor, k: int, group=None, exchange: str = "auto"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise global top-k of ``(R, V)`` logits sharded over the vocab.

    Each rank passes its ``(R, V_i)`` slice; the ``(R, k)`` result, the same
    on every rank, holds global vocab ids and feeds the samplers
    (``repro_torch.serving.sampler`` ``backend="distributed"``).
    """
    return _distributed_topk(x, k, group, exchange, batched=True)
