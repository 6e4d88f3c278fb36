"""Merge, sort and top-k surface on the hand-written Merge Path kernels.

The counterpart of the reference's ``repro/kernels/ops.py``, with its
dispatch:

* :func:`merge` / :func:`merge_kv`: the core rank merge when the whole
  merge fits in one tile (``n <= tile``), else one launch of K1 / K2;
* :func:`merge_batched`, :func:`merge_kv_batched`,
  :func:`merge_batched_ragged` and :func:`merge_kv_batched_ragged`: the
  core merge of the rows when a row pair fits in one tile
  (``na + nb <= tile``), else one launch of K5 / K6 / K7 / K8;
* :func:`merge_k`: the k-way tournament, ``ceil(log2 k)`` rounds of
  :func:`merge_batched_ragged` that read the previous round's even and
  odd rows in place;
* :func:`sort`, :func:`sort_kv`, :func:`sort_batched`,
  :func:`sort_kv_batched` and :func:`topk_batched`: bottom-up merge-sort
  rounds over a flat buffer of power-of-two rows.  The narrow rounds
  (``2 * width <= tile``) are one launch of the tile sort S1, which sorts
  each chunk of ``min(m, tile)`` keys stably (the same result: a stable
  sort has one output); wide rounds are launches of K3 (keys only) or K4
  (key-value), which share one sentinel tail appended once per sort, not
  once per round.  Integer
  keys-only sorts run K3; float keys compare their int
  :func:`~repro_torch.core.total_order_keys` (NaN last) through K4 with
  an index payload, and the result is gathered through that permutation;
* :func:`topk_batched_ragged`: the sampler's masked vocab, the keys past
  each row's length masked before the same K4 sort.

A CUDA tensor launches the kernels or raises; a CPU tensor runs their
plain versions.  There is no fallback chain from one to another.

**Guarded dispatch**: every public function routes through
:func:`repro_torch.runtime.resilience.guarded_call` under the reference's
op name, with its geometry (``meta``: length, tile, leaf, and the
largest block's shared memory, ``merge_path.smem_bytes``), the positions
of its key operands for the ``nan`` fault, and its verifier.  One attempt
(``"kernel"`` on a CUDA tensor, ``"plain"`` on a CPU one): a failed
preflight or launch raises ``GuardedDispatchError``, an output that fails
its verifier (while verification is active) ``VerificationError``.
Argument errors (dtypes, shapes, a tile that is not a power of two) raise
before the guard, as they do in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.registry import kernel_contract
from repro_torch.core import batched as _bat
from repro_torch.core import merge_path as _mp
from repro_torch.runtime import faults as _faults
from repro_torch.runtime import resilience as _res

from . import merge_path as _kern
from . import tune as _tune


def _resolve(n: int, tile: Optional[int], leaf: Optional[int],
             dtype: Optional[torch.dtype] = None) -> Tuple[int, int]:
    """Fill unspecified tile/leaf from :func:`tune.pick` for ``n`` elements
    of ``dtype``."""
    t, s = _tune.pick(n, dtype)
    tile = t if tile is None else tile
    leaf = s if leaf is None else leaf
    return tile, max(1, min(leaf, tile))


def _sort_tile(n: int, tile: Optional[int], leaf: Optional[int],
               dtype: Optional[torch.dtype] = None) -> Tuple[int, int]:
    """Tile/leaf for the sorts.  The flat rounds need ``tile | 2 * width``
    with power-of-two widths, so a tile passed explicitly must be a power
    of two."""
    tile, leaf = _resolve(n, tile, leaf, dtype)
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"sort tile must be a power of two (flat sort rounds require tile | 2 * width), got {tile}")
    return tile, leaf


# ---------------------------------------------------------------------------
# guarded dispatch plumbing
# ---------------------------------------------------------------------------


def _meta(n: int, dtype: torch.dtype, tile=None, leaf=None, batch: int = 1, ragged: bool = False,
          smem: Optional[int] = None) -> dict:
    """The call's geometry for the preflight and the ``op/`` span: the
    reference's keys, with its dtype names, and ``smem`` for a call that
    launches a kernel itself."""
    meta = {"n": int(n), "batch": int(batch), "dtype": str(dtype).removeprefix("torch."),
            "tile": None if tile is None else int(tile), "leaf": None if leaf is None else int(leaf),
            "ragged": bool(ragged)}
    if smem is not None:
        meta["smem"] = int(smem)
    return meta


def _guard(op: str, args: tuple, run, *, keys=(), meta: Optional[dict] = None, verifier=None):
    """One call of ``op`` through the guard: ``run(*args)`` as its one
    attempt.  ``keys`` are the positions of the key operands in ``args``
    for the ``nan`` fault.  Steps aside under ``REPRO_GUARD=0``,
    ``torch.compile`` and CUDA graph capture."""
    if not _res.guard_enabled() or _res.is_tracing():
        return run(*args)
    idx = _faults.next_index(op)
    args = _faults.maybe_nan_lace(op, idx, args, keys)
    return _res.guarded_call(op, [(_res.attempt_label(args[0]), lambda: run(*args))], index=idx, meta=meta,
                             verifier=verifier)


def _ragged_verifier(a_lens, b_lens, bsz: int, na: int, nb: int):
    """Order over each row's merged valid prefix of a ragged merge."""

    def check(out):
        keys = out[0] if isinstance(out, tuple) else out
        lens = _bat._as_lens(a_lens, bsz, na, keys.device) + _bat._as_lens(b_lens, bsz, nb, keys.device)
        return _res.sorted_verifier(lens)(out)

    return check


# ---------------------------------------------------------------------------
# merges
# ---------------------------------------------------------------------------

# Contracts (repro_torch.analysis.registry), with the reference's flags but one
# difference: the reference's keys-only merges (merge, merge_batched) rank on
# an unmasked path and state why ties are safe; every port kernel ends each
# side of a merge by index, never by comparing against a sentinel
# (csrc/segment_merge.cuh), so all the port's contracts are masked.


@kernel_contract(kind="merge", masked_ranks=True)
def merge(a: torch.Tensor, b: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None) -> torch.Tensor:
    """Stable A-priority merge of two sorted 1-D arrays.

    The operands are cast to :func:`~repro_torch.core.result_type` (JAX's
    promotion for int16, int32, bfloat16 and float32).  One K1 launch when
    ``na + nb > tile``, the core rank merge otherwise.
    """
    n = a.shape[0] + b.shape[0]
    dtype = _mp.result_type(a.dtype, b.dtype)
    tile, leaf = _resolve(n, tile, leaf, dtype)

    def run(a, b):
        if n <= tile:
            return _mp.merge(a, b)
        return _kern.merge(a.to(dtype).contiguous(), b.to(dtype).contiguous(), tile=tile, leaf=leaf)

    return _guard("merge", (a, b), run, keys=(0, 1),
                  meta=_meta(n, dtype, tile, leaf, smem=_kern.smem_bytes("merge", dtype.itemsize)),
                  verifier=_res.sorted_verifier())


@kernel_contract(kind="merge", carries_values=True, masked_ranks=True)
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
    kd = _mp.result_type(ak.dtype, bk.dtype)
    vd = _mp.result_type(av.dtype, bv.dtype)
    tile, leaf = _resolve(n, tile, leaf, kd)

    def run(ak, av, bk, bv):
        if n <= tile:
            return _mp.merge_kv(ak, av, bk, bv)
        return _kern.merge_kv(
            ak.to(kd).contiguous(), av.to(vd).contiguous(), bk.to(kd).contiguous(), bv.to(vd).contiguous(),
            tile=tile, leaf=leaf,
        )

    return _guard("merge_kv", (ak, av, bk, bv), run, keys=(0, 2),
                  meta=_meta(n, kd, tile, leaf, smem=_kern.smem_bytes("merge", kd.itemsize, values=True)),
                  verifier=_res.sorted_verifier())


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as rows the K5-K8 kernels read in place: any row stride, but
    adjacent elements."""
    return x if x.shape[1] <= 1 or x.stride(1) == 1 else x.contiguous()


def _kv_rows(k: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values as rows, the values at their keys' row stride."""
    k, v = _rows(k), _rows(v)
    if k.shape[0] > 1 and k.stride(0) != v.stride(0):
        return k.contiguous(), v.contiguous()
    return k, v


@kernel_contract(kind="merge", batched=True, masked_ranks=True)
def merge_batched(
    a: torch.Tensor, b: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None
) -> torch.Tensor:
    """Stable merge of ``B`` row pairs: ``(B, na) + (B, nb) -> (B, na + nb)``.

    The operands are cast to :func:`~repro_torch.core.result_type`.  One
    K5 launch for the whole batch when ``na + nb > tile``, the core
    batched merge otherwise.
    """
    n = a.shape[1] + b.shape[1]
    dtype = _mp.result_type(a.dtype, b.dtype)
    tile, leaf = _resolve(n, tile, leaf, dtype)

    def run(a, b):
        if n <= tile:
            return _bat.merge_batched(a, b)
        return _kern.merge_batched(_rows(a.to(dtype)), _rows(b.to(dtype)), tile=tile, leaf=leaf)

    return _guard("merge_batched", (a, b), run, keys=(0, 1),
                  meta=_meta(n, dtype, tile, leaf, batch=a.shape[0], smem=_kern.smem_bytes("rows", dtype.itemsize)),
                  verifier=_res.sorted_verifier())


@kernel_contract(kind="merge", batched=True, carries_values=True, masked_ranks=True)
def merge_kv_batched(
    ak: torch.Tensor,
    av: torch.Tensor,
    bk: torch.Tensor,
    bv: torch.Tensor,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable batched key-value merge: one K6 launch when ``na + nb > tile``,
    the core batched merge otherwise.  The kernel carries int32 or float32
    values."""
    n = ak.shape[1] + bk.shape[1]
    kd = _mp.result_type(ak.dtype, bk.dtype)
    vd = _mp.result_type(av.dtype, bv.dtype)
    tile, leaf = _resolve(n, tile, leaf, kd)

    def run(ak, av, bk, bv):
        if n <= tile:
            return _bat.merge_kv_batched(ak, av, bk, bv)
        ak, av = _kv_rows(ak.to(kd), av.to(vd))
        bk, bv = _kv_rows(bk.to(kd), bv.to(vd))
        return _kern.merge_kv_batched(ak, av, bk, bv, tile=tile, leaf=leaf)

    return _guard("merge_kv_batched", (ak, av, bk, bv), run, keys=(0, 2),
                  meta=_meta(n, kd, tile, leaf, batch=ak.shape[0],
                             smem=_kern.smem_bytes("rows", kd.itemsize, values=True)),
                  verifier=_res.sorted_verifier())


@kernel_contract(kind="merge", batched=True, ragged=True, masked_ranks=True)
def merge_batched_ragged(
    a: torch.Tensor,
    b: torch.Tensor,
    a_lens,
    b_lens,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> torch.Tensor:
    """Ragged batched merge: per-row valid lengths, sentinel after each
    row's merged prefix.

    The lengths are clipped to ``[0, n]`` (a scalar broadcasts).  One K7
    launch when ``na + nb > tile``, the core ragged merge otherwise.
    """
    (bsz, na), nb = a.shape, b.shape[1]
    dtype = _mp.result_type(a.dtype, b.dtype)
    tile, leaf = _resolve(na + nb, tile, leaf, dtype)

    def run(a, b, a_lens, b_lens):
        if na + nb <= tile:
            return _bat.merge_batched_ragged(a, b, a_lens, b_lens)
        a_lens = _bat._as_lens(a_lens, bsz, na, a.device)
        b_lens = _bat._as_lens(b_lens, bsz, nb, a.device)
        return _kern.merge_batched_ragged(_rows(a.to(dtype)), _rows(b.to(dtype)), a_lens, b_lens, tile=tile,
                                          leaf=leaf)

    return _guard("merge_batched_ragged", (a, b, a_lens, b_lens), run, keys=(0, 1),
                  meta=_meta(na + nb, dtype, tile, leaf, batch=bsz, ragged=True,
                             smem=_kern.smem_bytes("rows", dtype.itemsize)),
                  verifier=_ragged_verifier(a_lens, b_lens, bsz, na, nb))


@kernel_contract(kind="merge", batched=True, ragged=True, carries_values=True, masked_ranks=True)
def merge_kv_batched_ragged(
    ak: torch.Tensor,
    av: torch.Tensor,
    bk: torch.Tensor,
    bv: torch.Tensor,
    a_lens,
    b_lens,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged batched key-value merge: one K8 launch when ``na + nb > tile``,
    the core ragged merge otherwise.  Past each row's merged length the keys
    are sentinel and the values zero."""
    (bsz, na), nb = ak.shape, bk.shape[1]
    kd = _mp.result_type(ak.dtype, bk.dtype)
    vd = _mp.result_type(av.dtype, bv.dtype)
    tile, leaf = _resolve(na + nb, tile, leaf, kd)

    def run(ak, av, bk, bv, a_lens, b_lens):
        if na + nb <= tile:
            return _bat.merge_kv_batched_ragged(ak, av, bk, bv, a_lens, b_lens)
        a_lens = _bat._as_lens(a_lens, bsz, na, ak.device)
        b_lens = _bat._as_lens(b_lens, bsz, nb, ak.device)
        ak, av = _kv_rows(ak.to(kd), av.to(vd))
        bk, bv = _kv_rows(bk.to(kd), bv.to(vd))
        return _kern.merge_kv_batched_ragged(ak, av, bk, bv, a_lens, b_lens, tile=tile, leaf=leaf)

    return _guard("merge_kv_batched_ragged", (ak, av, bk, bv, a_lens, b_lens), run, keys=(0, 2),
                  meta=_meta(na + nb, kd, tile, leaf, batch=bsz, ragged=True,
                             smem=_kern.smem_bytes("rows", kd.itemsize, values=True)),
                  verifier=_ragged_verifier(a_lens, b_lens, bsz, na, nb))


@kernel_contract(kind="merge_k", ragged=True, masked_ranks=True)
def merge_k(
    runs: torch.Tensor,
    lens=None,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> torch.Tensor:
    """k-way tournament merge of the sorted rows of a ``(k, n)`` tensor.

    The contract of :func:`repro_torch.core.merge_k` for a stacked tensor:
    stable with lower-run priority; ``lens`` optionally gives each run's
    valid length; the output is always ``(k * n,)``: the merged valid
    elements, then sentinel padding.  The run count is padded to a power
    of two with zero-length runs, and each of the ``ceil(log2 k)`` rounds
    is one :func:`merge_batched_ragged` call whose A and B are the even
    and odd rows of the previous round, read in place (one K7 launch once
    a pair of runs is wider than a tile).
    """
    if not isinstance(runs, torch.Tensor) or runs.ndim != 2:
        raise ValueError(f"expected a (k, n) runs tensor, got {getattr(runs, 'shape', type(runs))}")
    k, n = runs.shape
    if lens is None:
        run_lens = torch.full((k,), n, dtype=torch.int32, device=runs.device)
    else:
        run_lens = _bat._as_lens(lens, k, n, runs.device)

    def run(runs):
        return _merge_k_rounds(runs, run_lens, tile, leaf)

    # as in the reference, the runs are not NaN-laced here: the rounds are
    # guarded calls of their own, which a plan naming them laces
    return _guard("merge_k", (runs,), run,
                  meta=_meta(k * n, runs.dtype, batch=k, ragged=True),
                  verifier=lambda out: _res.sorted_verifier(run_lens.sum().reshape(1))(out))


def _merge_k_rounds(runs: torch.Tensor, run_lens: torch.Tensor, tile: Optional[int], leaf: Optional[int]) -> torch.Tensor:
    """The tournament of :func:`merge_k`: ``ceil(log2 k)`` guarded
    :func:`merge_batched_ragged` rounds over the power-of-two padded runs."""
    k, n = runs.shape
    sent = _mp.max_sentinel(runs.dtype)
    if k == 1:  # no round runs: mask the tail here
        return _bat._mask_rows(runs, run_lens, sent)[0]
    stacked, run_lens = _bat._pad_runs_pow2(_rows(runs), run_lens, sent)
    while stacked.shape[0] > 1:
        stacked = merge_batched_ragged(
            stacked[0::2], stacked[1::2], run_lens[0::2], run_lens[1::2], tile=tile, leaf=leaf
        )
        run_lens = run_lens[0::2] + run_lens[1::2]
    return stacked[0][: k * n]  # the pad rows add only trailing sentinels


# ---------------------------------------------------------------------------
# sorts: flat rounds, padding hoisted out of the loop
# ---------------------------------------------------------------------------


def _narrow_chunk(m: int, tile: int, dtype: torch.dtype) -> Tuple[int, int]:
    """``(chunk, width)``: S1 sorts chunks of ``chunk`` keys, and the core
    merges take the narrow rounds from there up to runs of ``width =
    min(m, tile)``: the rounds past ``MAX_TILE`` (an explicit tile past
    it), and all of them for keys S1 does not take (it takes the wide
    rounds' int16 and int32)."""
    width = min(m, tile)
    if dtype not in _kern.KEY_DTYPES:
        return 1, width
    return min(width, _kern.MAX_TILE), width


def _sort_rounds(flat: torch.Tensor, m: int, tile: int, leaf: int) -> torch.Tensor:
    """Bottom-up keys-only merge sort over a flat ``(B * m,)`` buffer of
    width-1 runs (``m`` = per-row power-of-two width, so no pair straddles
    two rows): one tile sort (S1) of the narrow rounds, then the wide
    rounds."""
    chunk, width = _narrow_chunk(m, tile, flat.dtype)
    if chunk > 1:
        flat = _kern.sort_tiles(flat, chunk)
    flat = _kern.narrow_rounds(flat, chunk, width)
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
    chunk, width = _narrow_chunk(m, tile, kflat.dtype)
    if chunk > 1:
        kflat, vflat = _kern.sort_tiles_kv(kflat, vflat, chunk)
    kflat, vflat = _kern.narrow_rounds_kv(kflat, vflat, chunk, width)
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


def _argsort_batched(
    keys: torch.Tensor, n: int, tile: int, leaf: int, lens: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Stable row-wise argsort (int32) of ``(B, n)`` keys: K4 over the int
    total-order keys (floats: NaN last) or the keys themselves, with an
    index payload.  With ``lens``, the keys past each row's length are
    masked with the sentinel first, so they sort after every valid key."""
    idx = torch.arange(n, dtype=torch.int32, device=keys.device).expand(keys.shape[0], n)
    keys = _mp.total_order_keys(keys)
    if lens is not None:
        keys = _bat._mask_rows(keys, lens, _mp.max_sentinel(keys.dtype))
    _, perm = _sort_kv_batched_impl(keys, idx, n, tile, leaf)
    return perm


def _sort_rows(x: torch.Tensor, tile: int, leaf: int) -> torch.Tensor:
    """Row-wise sort of ``(B, n)``, ``n >= 2``: integer rows on the keys-only
    rounds (K3), float rows gathered through the stable argsort of their
    total-order keys (K4)."""
    bsz, n = x.shape
    if x.is_floating_point():
        return torch.gather(x, 1, _argsort_batched(x, n, tile, leaf).long())
    xp = _bat._pad_rows_pow2(x, _mp.max_sentinel(x.dtype))
    m = xp.shape[1]
    return _sort_rounds(xp.reshape(-1), m, tile, leaf).reshape(bsz, m)[:, :n]


def _sort_kv_rows(keys: torch.Tensor, values: torch.Tensor, tile: int, leaf: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable key-value sort of ``(B, n)``, ``n >= 2``."""
    n = keys.shape[1]
    if keys.is_floating_point() or values.dtype != torch.int32:
        perm = _argsort_batched(keys, n, tile, leaf).long()
        return torch.gather(keys, 1, perm), torch.gather(values, 1, perm)
    return _sort_kv_batched_impl(keys, values, n, tile, leaf)


def _sort_meta(keys: torch.Tensor, tile: int, leaf: int, values: bool, ragged: bool = False) -> dict:
    """A sort's geometry; its ``smem`` the larger block of its S1 launch and
    its wide rounds (K3, or K4 for values and for float keys, which ride
    with an index payload)."""
    bsz, n = (1, keys.shape[0]) if keys.ndim == 1 else keys.shape
    kb, values = keys.element_size(), values or keys.is_floating_point()
    smem = max(_kern.smem_bytes("tiles", kb, values, min(tile, _kern.MAX_TILE)), _kern.smem_bytes("round", kb, values))
    return _meta(n, keys.dtype, tile, leaf, batch=bsz, ragged=ragged, smem=smem)


@kernel_contract(kind="sort", batched=True, masked_ranks=True, pow2_tile=True, differentiable=True)
def sort_batched(x: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None) -> torch.Tensor:
    """Sort every row of ``(B, n)`` ascending.  The batch axis is folded into
    the run-pair axis, so a round is one launch whatever ``B`` is.

    Integer rows run the keys-only rounds (K3).  Float rows are gathered
    through the stable argsort of their total-order keys (K4), so NaN
    sorts last and equal floats (``-0.0`` and ``+0.0``) keep their order.
    """
    n = x.shape[1]
    if n <= 1:
        return x
    tile, leaf = _sort_tile(n, tile, leaf, x.dtype)
    return _guard("sort_batched", (x,), lambda x: _sort_rows(x, tile, leaf), keys=(0,),
                  meta=_sort_meta(x, tile, leaf, values=False), verifier=_res.sorted_verifier())


@kernel_contract(kind="sort", batched=True, carries_values=True, masked_ranks=True, pow2_tile=True,
                 differentiable=True)
def sort_kv_batched(
    keys: torch.Tensor, values: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable key-value sort of ``(B, n)`` keys (ascending).

    Integer keys with int32 values run K4 directly; float keys, or values
    of another dtype, are gathered through the stable argsort.
    """
    n = keys.shape[1]
    if n <= 1:
        return keys, values
    tile, leaf = _sort_tile(n, tile, leaf, keys.dtype)
    return _guard("sort_kv_batched", (keys, values), lambda k, v: _sort_kv_rows(k, v, tile, leaf), keys=(0,),
                  meta=_sort_meta(keys, tile, leaf, values=True), verifier=_res.sorted_verifier())


@kernel_contract(kind="sort", masked_ranks=True, pow2_tile=True, differentiable=True)
def sort(x: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None) -> torch.Tensor:
    """Bottom-up merge sort of a 1-D array: the rounds of :func:`sort_batched` on one row."""
    n = x.shape[0]
    if n <= 1:
        return x
    tile, leaf = _sort_tile(n, tile, leaf, x.dtype)
    return _guard("sort", (x,), lambda x: _sort_rows(x[None, :], tile, leaf)[0], keys=(0,),
                  meta=_sort_meta(x, tile, leaf, values=False), verifier=_res.sorted_verifier())


@kernel_contract(kind="sort", carries_values=True, masked_ranks=True, pow2_tile=True, differentiable=True)
def sort_kv(
    keys: torch.Tensor, values: torch.Tensor, *, tile: Optional[int] = None, leaf: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value merge sort of 1-D arrays: the rounds of :func:`sort_kv_batched` on one row."""
    n = keys.shape[0]
    if n <= 1:
        return keys, values
    tile, leaf = _sort_tile(n, tile, leaf, keys.dtype)

    def run(k, v):
        ks, vs = _sort_kv_rows(k[None, :], v[None, :], tile, leaf)
        return ks[0], vs[0]

    return _guard("sort_kv", (keys, values), run, keys=(0,), meta=_sort_meta(keys, tile, leaf, values=True),
                  verifier=_res.sorted_verifier())


@kernel_contract(kind="topk", batched=True, carries_values=True, masked_ranks=True, pow2_tile=True,
                 differentiable=True)
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
    tile, leaf = _sort_tile(n, tile, leaf, x.dtype)

    def run(x):
        top_idx = _argsort_batched(_mp.flip_desc(x), n, tile, leaf)[:, :k]
        return torch.gather(x, 1, top_idx.long()), top_idx

    return _guard("topk_batched", (x,), run, keys=(0,), meta=_sort_meta(x, tile, leaf, values=True),
                  verifier=_res.topk_verifier())


@kernel_contract(kind="topk", batched=True, ragged=True, carries_values=True, masked_ranks=True,
                 pow2_tile=True, differentiable=True)
def topk_batched_ragged(
    x: torch.Tensor,
    k: int,
    lens,
    *,
    tile: Optional[int] = None,
    leaf: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged row-wise descending top-k on the kernel-backed batched kv-sort.

    The contract of :func:`repro_torch.core.topk_batched_ragged`: ``(values,
    int32 indices)``, each ``(B, min(k, n))``, over each row's valid
    prefix ``x[r, :lens[r]]``; slots past a row's length return index
    ``-1`` and the dtype's minimum.  The keys past each length are masked
    with the sentinel before the same sort as :func:`topk_batched`, whose
    wide rounds launch K4 on a CUDA ``x``.
    """
    if x.ndim != 2:
        raise ValueError(f"topk_batched_ragged expects (B, n) rows, got shape {tuple(x.shape)}")
    bsz, n = x.shape
    k = min(k, n)
    lens = _bat._as_lens(lens, bsz, n, x.device)
    tile, leaf = _sort_tile(n, tile, leaf, x.dtype)

    def run(x, lens):
        top_idx = _argsort_batched(_mp.flip_desc(x), n, tile, leaf, lens)[:, :k]
        return _bat._mask_topk(x, top_idx, lens)

    return _guard("topk_batched_ragged", (x, lens), run, keys=(0,),
                  meta=_sort_meta(x, tile, leaf, values=True, ragged=True), verifier=_res.topk_verifier())
