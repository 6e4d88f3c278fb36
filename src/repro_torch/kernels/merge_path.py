"""The Merge Path kernels written by hand for Hopper, with their plain versions.

The counterparts of the reference's Pallas entry points
(``repro/kernels/merge_path.py``):

* :func:`merge` (K1, ``merge_pallas``) and :func:`merge_kv` (K2,
  ``merge_kv_pallas``): stable A-priority merges of two sorted 1-D arrays,
  ``csrc/merge.cu``;
* :func:`sort_round` (K3, ``sort_round_pallas``) and :func:`sort_round_kv`
  (K4, ``sort_round_kv_pallas``): one flat merge-sort round, keys only and
  with values, one kernel template in ``csrc/sort_round.cu``;
* :func:`sort_tiles` and :func:`sort_tiles_kv` (S1, no Pallas counterpart:
  the reference runs the same narrow rounds in XLA): every chunk of a flat
  buffer sorted stably in one launch, ``csrc/sort_tiles.cu``;
* :func:`merge_batched` (K5, ``merge_batched_pallas``),
  :func:`merge_kv_batched` (K6, ``merge_kv_batched_pallas``),
  :func:`merge_batched_ragged` (K7, ``merge_batched_ragged_pallas``) and
  :func:`merge_kv_batched_ragged` (K8, ``merge_kv_batched_ragged_pallas``):
  ``B`` independent row merges, the ragged ones with per-row valid
  lengths, ``csrc/merge.cu``.

Every one of them runs the per-thread segment merge of
``csrc/segment_merge.cuh``.  A sort keeps one flat buffer of ``m + tile``
elements: ``m`` data elements in sorted runs of ``width``, then ``tile``
sentinel keys (with zero values).  One round merges each pair of runs into
a run of ``2 * width`` and returns the same layout.

Each wrapper launches its kernel on a CUDA tensor (and counts the launch
in ``<wrapper>.launches``) and raises if the launch fails; on a CPU tensor
it runs the plain version beside it (``<wrapper>_ref``).  There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import batched as _bat
from repro_torch.core import merge_path as _mp

from . import _build
from .ref import sort_kv_ref, sort_ref

DEFAULT_TILE = 512
DEFAULT_LEAF = 32
# The largest chunk of the tile sort S1 (kMaxChunk in csrc/sort_tiles.cu): the
# largest ``chunk`` its wrappers take, and the largest ``tile`` of the merge
# and round wrappers.
MAX_TILE = 4096
# Outputs per block of K1 and of K2, whatever the tile: kSpan<false> and
# kSpan<true> in csrc/merge.cu, which must agree.
MERGE_SPAN = 8192
MERGE_KV_SPAN = 4096
# Outputs per block of each row of K5 and K7, and of K6 and K8, whatever the
# tile: kRowsSpan and kRowsKvSpan in csrc/merge.cu, which must agree.
MERGE_ROWS_SPAN = 4096
MERGE_ROWS_KV_SPAN = 2048
# The most outputs per block of K4, which a round takes when its pairs are at
# least that wide and it has at least 128 such blocks (smaller rounds give a
# thread fewer outputs): kThreads * kE<true> in csrc/sort_round.cu, which
# must agree.
SORT_ROUND_KV_SPAN = 2048
# The most outputs per block of K3: kThreads * kE<false> in csrc/sort_round.cu.
SORT_ROUND_SPAN = 4096
# S1's block for chunks up to it (one warp of kE = MAX_TILE / 256 keys a
# thread): kWarpSpan in csrc/sort_tiles.cu; wider chunks take MAX_TILE.
SORT_TILES_WARP_SPAN = 512
KEY_DTYPES = (torch.int16, torch.int32)
MERGE_KEY_DTYPES = (torch.int16, torch.int32, torch.float32, torch.bfloat16)
MERGE_VALUE_DTYPES = (torch.int32, torch.float32)

_SUFFIX = {torch.int16: "i16", torch.int32: "i32", torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_ARGTYPES = {
    "merge": [_P, _I64, _P, _I64, _P, _I, _I, _P],
    "merge_kv": [_P, _P, _I64, _P, _P, _I64, _P, _P, _I, _I, _P],
    "sort_round": [_P, _P, _I, _I, _I, _I, _P],
    "sort_round_kv": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "sort_tiles": [_P, _P, _I64, _I, _P],
    "sort_tiles_kv": [_P, _P, _P, _P, _I64, _I, _P],
    "merge_batched": [_P, _I64, _I64, _P, _I64, _I64, _P, _I64, _I64, _I, _I, _P],
    "merge_kv_batched": [_P, _P, _I64, _I64, _P, _P, _I64, _I64, _P, _P, _I64, _I64, _I, _I, _P],
    "merge_batched_ragged": [_P, _I64, _I64, _P, _P, _I64, _I64, _P, _P, _I64, _I64, _I, _I, _P],
    "merge_kv_batched_ragged": [_P, _P, _I64, _I64, _P, _P, _P, _I64, _I64, _P, _P, _P, _I64, _I64, _I, _I, _P],
}


def _spad_slots(n: int, size: int) -> int:
    """``spad_slots<T>(n)`` of csrc/segment_merge.cuh: ``n`` elements of
    ``size`` bytes with one pad slot every 128 bytes, in 16-byte vectors."""
    vec = 16 // size
    padded = n + (n // (128 // size) + 1) * (4 // size)
    return -(-padded // vec) * vec


# K3/K4's block: threads, and the data blocks a round keeps by giving a thread
# fewer outputs (kThreads and kMinBlocks in csrc/sort_round.cu).
SORT_ROUND_THREADS = 256
SORT_ROUND_MIN_BLOCKS = 128
# the key code of each dtype in the C sources' `<kernel>_smem_bytes` entries
KEY_CODE = {torch.int16: 0, torch.int32: 1, torch.float32: 2, torch.bfloat16: 3}


def round_span(m: int, width: int, values: bool) -> int:
    """Outputs per block of a K3 (K4 with ``values``) round of ``m`` data
    keys in runs of ``width``: ``outputs_per_thread`` of csrc/sort_round.cu
    (16 keys a thread, 8 with values, halved while the round would have
    fewer than 128 blocks, never more than a pair) times its 256 threads."""
    e = (SORT_ROUND_KV_SPAN if values else SORT_ROUND_SPAN) // SORT_ROUND_THREADS
    while e > 1 and m < SORT_ROUND_MIN_BLOCKS * SORT_ROUND_THREADS * e:
        e >>= 1
    return SORT_ROUND_THREADS * min(e, 2 * width)


def smem_bytes(kernel: str, key_bytes: int, values: bool = False, chunk: int = MAX_TILE,
               span: Optional[int] = None) -> int:
    """The dynamic shared memory one block of ``kernel`` requests, as the
    C sources size it from the spans above: ``"merge"`` (K1/K2), ``"rows"``
    (K5-K8), ``"round"`` (K3/K4: its widest block, or the block of
    ``span`` outputs a round's :func:`round_span` gives) and ``"tiles"``
    (S1 at ``chunk``, two buffers).  Values are 4 bytes.  Each source's
    ``<kernel>_smem_bytes`` returns what its launch requests, which the
    card's check holds equal to this."""
    if kernel == "tiles":
        span = SORT_TILES_WARP_SPAN if chunk <= SORT_TILES_WARP_SPAN else MAX_TILE
    elif kernel == "round" and span is not None:
        pass
    else:
        span = {"merge": (MERGE_SPAN, MERGE_KV_SPAN), "rows": (MERGE_ROWS_SPAN, MERGE_ROWS_KV_SPAN),
                "round": (SORT_ROUND_SPAN, SORT_ROUND_KV_SPAN)}[kernel][int(values)]
    need = _spad_slots(span + 1, key_bytes) * key_bytes + (_spad_slots(span + 1, 4) * 4 if values else 0)
    return 2 * need if kernel == "tiles" else need


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _leaf(tile: int, leaf: int) -> int:
    return max(1, min(int(leaf), tile))


@functools.cache
def _symbol(source: str, kernel: str, dtype: torch.dtype):
    """The C entry point ``<kernel>_<dtype>`` of ``csrc/<source>.cu``."""
    lib = _build.load(source)
    fn = getattr(lib, f"{kernel}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGTYPES[kernel]
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return fn, lib


def _launch(what: str, source: str, kernel: str, dtype: torch.dtype, device: torch.device, *args) -> None:
    """Launch on ``device``'s current stream; raise if the launch is refused."""
    fn, lib = _symbol(source, kernel, dtype)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{what} launch failed: {lib.repro_cuda_error_string(err).decode()} (cudaError {err})")


def _on_card(what: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


# ---------------------------------------------------------------------------
# K1 / K2: 1-D merges
# ---------------------------------------------------------------------------


def _check_merge(what: str, a: torch.Tensor, b: torch.Tensor, tile: int, dtypes) -> None:
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: the kernel takes equal dtypes, got {a.dtype} and {b.dtype}")
    if a.dtype not in dtypes:
        raise TypeError(f"{what}: dtype {a.dtype} is not one of {dtypes}")
    if a.ndim != 1 or b.ndim != 1:
        raise ValueError(f"{what}: expected 1-D arrays, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands on {a.device} and {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what}: operands must be contiguous")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"{what}: tile must lie in [1, {MAX_TILE}], got {tile}")


def merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the rank merge of :func:`repro_torch.core.merge`.

    It compares with the raw ``<`` and ``<=``, as the kernel does, so
    ``-0.0`` and ``+0.0`` tie and A's comes first.
    """
    return _mp.merge(a, b)


def merge_kv_ref(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: the rank merge of :func:`repro_torch.core.merge_kv`."""
    return _mp.merge_kv(ak, av, bk, bv)


def merge(a: torch.Tensor, b: torch.Tensor, *, tile: int = DEFAULT_TILE, leaf: int = DEFAULT_LEAF) -> torch.Tensor:
    """Stable A-priority merge of two sorted 1-D arrays of one dtype (K1).

    Keys are int16, int32, float32 or bfloat16, compared with the raw
    ``<=``.  The operands may start at any element.  The kernel writes
    :data:`MERGE_SPAN` outputs per block, each thread merging 16 of them
    after one co-rank search; ``tile`` and ``leaf`` are the reference's
    parameters, checked here and ignored by the kernel (the stable merge has
    one result whatever they are).  Returns the ``na + nb`` merged keys.

    A CUDA tensor launches the kernel (and counts one in
    ``merge.launches``; two empty arrays launch nothing); a CPU tensor
    takes :func:`merge_ref`.
    """
    _check_merge("merge", a, b, tile, MERGE_KEY_DTYPES)
    if not _on_card("merge", a):
        return merge_ref(a, b)
    out = torch.empty(a.shape[0] + b.shape[0], dtype=a.dtype, device=a.device)
    if out.numel():
        _launch("merge", "merge", "merge", a.dtype, a.device,
                a.data_ptr(), a.shape[0], b.data_ptr(), b.shape[0], out.data_ptr(), tile, _leaf(tile, leaf))
        merge.launches += 1
    return out


merge.launches = 0


def merge_kv(
    ak: torch.Tensor,
    av: torch.Tensor,
    bk: torch.Tensor,
    bv: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    leaf: int = DEFAULT_LEAF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable A-priority key-value merge of two sorted 1-D arrays (K2).

    Keys as in :func:`merge`; values are int32 or float32, one dtype, one
    per key.  The kernel is :func:`merge`'s with the values moved beside
    the keys, :data:`MERGE_KV_SPAN` outputs per block.  Returns the merged
    ``(keys, values)``.  A CUDA tensor
    launches the kernel (counted in ``merge_kv.launches``); a CPU tensor
    takes :func:`merge_kv_ref`.
    """
    _check_merge("merge_kv", ak, bk, tile, MERGE_KEY_DTYPES)
    _check_merge("merge_kv", av, bv, tile, MERGE_VALUE_DTYPES)
    if av.shape != ak.shape or bv.shape != bk.shape:
        raise ValueError(
            f"merge_kv: value shapes must match key shapes: keys {tuple(ak.shape)}/{tuple(bk.shape)}, "
            f"values {tuple(av.shape)}/{tuple(bv.shape)}"
        )
    if av.device != ak.device:
        raise ValueError(f"merge_kv: keys on {ak.device}, values on {av.device}")
    if not _on_card("merge_kv", ak):
        return merge_kv_ref(ak, av, bk, bv)
    n = ak.shape[0] + bk.shape[0]
    ko = torch.empty(n, dtype=ak.dtype, device=ak.device)
    vo = torch.empty(n, dtype=av.dtype, device=ak.device)
    if n:
        _launch("merge_kv", "merge", "merge_kv", ak.dtype, ak.device,
                ak.data_ptr(), av.data_ptr(), ak.shape[0], bk.data_ptr(), bv.data_ptr(), bk.shape[0],
                ko.data_ptr(), vo.data_ptr(), tile, _leaf(tile, leaf))
        merge_kv.launches += 1
    return ko, vo


merge_kv.launches = 0


# ---------------------------------------------------------------------------
# K3 / K4: flat merge-sort rounds
# ---------------------------------------------------------------------------


def _check_flat(what: str, kf: torch.Tensor, vf: Optional[torch.Tensor]) -> None:
    """Checks of a flat sort buffer: 1-D int16 or int32 keys, and int32
    values of the same shape where there are values, contiguous."""
    if kf.dtype not in KEY_DTYPES:
        raise TypeError(f"{what}: keys must be int16 or int32, got {kf.dtype}")
    if kf.ndim != 1:
        raise ValueError(f"{what}: expected 1-D keys, got {tuple(kf.shape)}")
    if vf is not None:
        if vf.dtype != torch.int32:
            raise TypeError(f"{what}: values must be int32, got {vf.dtype}")
        if vf.shape != kf.shape:
            raise ValueError(f"{what}: expected equal 1-D keys and values, got {tuple(kf.shape)} and {tuple(vf.shape)}")
        if kf.device != vf.device:
            raise ValueError(f"{what}: keys on {kf.device}, values on {vf.device}")
    if not (kf.is_contiguous() and (vf is None or vf.is_contiguous())):
        raise ValueError(f"{what}: keys and values must be contiguous")


def _check_round(what: str, kf: torch.Tensor, width: int, tile: int, vf: Optional[torch.Tensor] = None) -> int:
    """Validate one round's operands; returns ``m``, the data length."""
    _check_flat(what, kf, vf)
    if not (_is_pow2(width) and _is_pow2(tile)) or (2 * width) % tile or tile > MAX_TILE:
        raise ValueError(
            f"{what}: need power-of-two width and tile <= {MAX_TILE} with tile | 2*width, got width={width} tile={tile}"
        )
    m = kf.shape[0] - tile
    if m <= 0 or m % (2 * width):
        raise ValueError(f"{what}: data length {m} is not a positive multiple of 2*width={2 * width}")
    return m


def _tail(x: torch.Tensor, tile: int, fill) -> torch.Tensor:
    return torch.full((tile,), fill, dtype=x.dtype, device=x.device)


def sort_round_ref(xf: torch.Tensor, width: int, *, tile: int = DEFAULT_TILE) -> torch.Tensor:
    """Plain version of K3: a stable ``torch.sort`` of each pair of runs
    (integer keys), then the sentinel tail rewritten."""
    m = _check_round("sort_round", xf, width, tile)
    pairs = sort_ref(xf[:m].view(m // (2 * width), 2 * width))
    return torch.cat([pairs.reshape(-1), _tail(xf, tile, _mp.max_sentinel(xf.dtype))])


def sort_round(xf: torch.Tensor, width: int, *, tile: int = DEFAULT_TILE, leaf: int = DEFAULT_LEAF) -> torch.Tensor:
    """One bottom-up keys-only merge-sort round on the flat padded layout (K3).

    ``xf`` (int16 or int32) is ``(m + tile,)``: runs of ``width`` sorted
    keys, then ``tile`` sentinels.  ``width`` and ``tile`` are powers of
    two with ``tile | 2 * width``, and ``m`` is a multiple of ``2 * width``.
    ``leaf`` is the reference's level-2 leaf width, kept for parity with
    ``sort_round_pallas``: the kernel merges a segment per thread, has no
    leaves and ignores it (the result does not depend on it).  Returns new
    keys holding runs of ``2 * width``.

    A CUDA tensor launches the kernel (and counts one in
    ``sort_round.launches``); a CPU tensor takes :func:`sort_round_ref`.
    """
    m = _check_round("sort_round", xf, width, tile)
    if not _on_card("sort_round", xf):
        return sort_round_ref(xf, width, tile=tile)
    out = torch.empty_like(xf)
    _launch("sort_round", "sort_round", "sort_round", xf.dtype, xf.device,
            xf.data_ptr(), out.data_ptr(), width, tile, _leaf(tile, leaf), m // tile)
    sort_round.launches += 1
    return out


sort_round.launches = 0


def sort_round_kv_ref(
    kf: torch.Tensor, vf: torch.Tensor, width: int, *, tile: int = DEFAULT_TILE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4: a stable ``torch.sort`` of each pair.

    A stable sort of ``[A; B]`` is exactly the A-priority merge of two
    sorted runs.  The values follow the keys' permutation; the tail is
    rewritten with sentinel keys and zero values.
    """
    m = _check_round("sort_round_kv", kf, width, tile, vf)
    pairs = m // (2 * width)
    ks, vs = sort_kv_ref(kf[:m].view(pairs, 2 * width), vf[:m].view(pairs, 2 * width))
    return (torch.cat([ks.reshape(-1), _tail(kf, tile, _mp.max_sentinel(kf.dtype))]),
            torch.cat([vs.reshape(-1), _tail(vf, tile, 0)]))


def sort_round_kv(
    kf: torch.Tensor,
    vf: torch.Tensor,
    width: int,
    *,
    tile: int = DEFAULT_TILE,
    leaf: int = DEFAULT_LEAF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bottom-up key-value merge-sort round on the flat padded layout (K4).

    ``kf`` (int16 or int32) and ``vf`` (int32) are ``(m + tile,)``: runs of
    ``width`` sorted keys, then ``tile`` sentinels with zero values; the
    rules on ``width``, ``tile`` and ``m`` are :func:`sort_round`'s.
    ``leaf`` is kept for parity with ``sort_round_kv_pallas``; the kernel,
    :func:`sort_round`'s with the values riding along, ignores it, and
    ``tile`` sets only the tail.  Returns new ``(keys, values)`` holding
    runs of ``2 * width``.

    A CUDA tensor launches the kernel (and counts one in
    ``sort_round_kv.launches``); a CPU tensor takes
    :func:`sort_round_kv_ref`.
    """
    m = _check_round("sort_round_kv", kf, width, tile, vf)
    if not _on_card("sort_round_kv", kf):
        return sort_round_kv_ref(kf, vf, width, tile=tile)
    ko = torch.empty_like(kf)
    vo = torch.empty_like(vf)
    _launch("sort_round_kv", "sort_round", "sort_round_kv", kf.dtype, kf.device,
            kf.data_ptr(), vf.data_ptr(), ko.data_ptr(), vo.data_ptr(), width, tile, _leaf(tile, leaf), m // tile)
    sort_round_kv.launches += 1
    return ko, vo


sort_round_kv.launches = 0

# ---------------------------------------------------------------------------
# S1: the tile sort, every narrow round of a flat sort in one launch
# ---------------------------------------------------------------------------


def _check_tiles(what: str, kf: torch.Tensor, chunk: int, vf: Optional[torch.Tensor] = None) -> None:
    _check_flat(what, kf, vf)
    if not (_is_pow2(chunk) and 2 <= chunk <= MAX_TILE):
        raise ValueError(f"{what}: chunk must be a power of two in [2, {MAX_TILE}], got {chunk}")
    if kf.shape[0] % chunk:
        raise ValueError(f"{what}: length {kf.shape[0]} is not a multiple of the chunk {chunk}")


def narrow_rounds(xf: torch.Tensor, width: int, chunk: int) -> torch.Tensor:
    """The flat sort's narrow rounds from runs of ``width`` up to runs of
    ``chunk``: per round, one batched rank merge
    (:func:`repro_torch.core.merge_batched`) of every pair of runs, as the
    reference runs them in XLA."""
    while width < chunk:
        runs = xf.reshape(-1, 2, width)
        xf = _bat.merge_batched(runs[:, 0], runs[:, 1]).reshape(-1)
        width *= 2
    return xf


def narrow_rounds_kv(kf: torch.Tensor, vf: torch.Tensor, width: int, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Key-value :func:`narrow_rounds` (:func:`repro_torch.core.merge_kv_batched`)."""
    while width < chunk:
        kr = kf.reshape(-1, 2, width)
        vr = vf.reshape(-1, 2, width)
        kf, vf = _bat.merge_kv_batched(kr[:, 0], vr[:, 0], kr[:, 1], vr[:, 1])
        kf, vf = kf.reshape(-1), vf.reshape(-1)
        width *= 2
    return kf, vf


def sort_tiles_ref(xf: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain version of S1: the narrow rounds, widths 1 to ``chunk / 2``."""
    _check_tiles("sort_tiles", xf, chunk)
    return narrow_rounds(xf, 1, chunk)


def sort_tiles(xf: torch.Tensor, chunk: int) -> torch.Tensor:
    """Sort each consecutive chunk of ``chunk`` keys of a flat buffer (S1).

    ``xf`` is ``(n,)`` int16 or int32, contiguous, ``n`` a multiple of
    ``chunk``, a power of two in ``[2, MAX_TILE]``.  The sort is stable, so
    the result is exactly that of the flat sort's narrow rounds from width
    1 to ``chunk / 2`` (:func:`sort_tiles_ref`).

    A CUDA tensor launches the kernel (and counts one in
    ``sort_tiles.launches``; an empty buffer launches nothing); a CPU
    tensor takes :func:`sort_tiles_ref`.
    """
    _check_tiles("sort_tiles", xf, chunk)
    if not _on_card("sort_tiles", xf):
        return sort_tiles_ref(xf, chunk)
    out = torch.empty_like(xf)
    if out.numel():
        _launch("sort_tiles", "sort_tiles", "sort_tiles", xf.dtype, xf.device,
                xf.data_ptr(), out.data_ptr(), xf.shape[0], chunk)
        sort_tiles.launches += 1
    return out


sort_tiles.launches = 0


def sort_tiles_kv_ref(kf: torch.Tensor, vf: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the key-value S1: the narrow key-value rounds."""
    _check_tiles("sort_tiles_kv", kf, chunk, vf)
    return narrow_rounds_kv(kf, vf, 1, chunk)


def sort_tiles_kv(kf: torch.Tensor, vf: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value sort of each chunk of ``chunk`` keys (S1 with values).

    Keys as in :func:`sort_tiles`, int32 values of the same shape; equal
    keys keep their input order.  A CUDA tensor launches the kernel
    (counted in ``sort_tiles_kv.launches``); a CPU tensor takes
    :func:`sort_tiles_kv_ref`.
    """
    _check_tiles("sort_tiles_kv", kf, chunk, vf)
    if not _on_card("sort_tiles_kv", kf):
        return sort_tiles_kv_ref(kf, vf, chunk)
    ko = torch.empty_like(kf)
    vo = torch.empty_like(vf)
    if ko.numel():
        _launch("sort_tiles_kv", "sort_tiles", "sort_tiles_kv", kf.dtype, kf.device,
                kf.data_ptr(), vf.data_ptr(), ko.data_ptr(), vo.data_ptr(), kf.shape[0], chunk)
        sort_tiles_kv.launches += 1
    return ko, vo


sort_tiles_kv.launches = 0

# ---------------------------------------------------------------------------
# K5 - K8: B row merges, ragged or not
# ---------------------------------------------------------------------------


def _row_stride(x: torch.Tensor) -> int:
    """The row stride of ``(B, n)`` rows whose elements are adjacent."""
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"rows must have unit element stride, got strides {x.stride()}")
    return x.stride(0)


def _check_rows(what: str, a: torch.Tensor, b: torch.Tensor, tile: int, dtypes, kind: str = "keys") -> None:
    """Checks of a pair of ``(B, na)``/``(B, nb)`` row operands."""
    if a.dtype != b.dtype:
        raise TypeError(f"{what}: the kernel takes equal {kind} dtypes, got {a.dtype} and {b.dtype}")
    if a.dtype not in dtypes:
        raise TypeError(f"{what}: {kind} dtype {a.dtype} is not one of {dtypes}")
    if a.ndim != 2 or b.ndim != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"{what}: expected (B, na) and (B, nb) with equal B, got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"{what}: operands on {a.device} and {b.device}")
    _row_stride(a)
    _row_stride(b)
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"{what}: tile must lie in [1, {MAX_TILE}], got {tile}")


def _check_row_values(what: str, ak, av, bk, bv, tile: int) -> None:
    _check_rows(what, ak, bk, tile, MERGE_KEY_DTYPES)
    _check_rows(what, av, bv, tile, MERGE_VALUE_DTYPES, "values")
    if av.shape != ak.shape or bv.shape != bk.shape:
        raise ValueError(
            f"{what}: value shapes must match key shapes: keys {tuple(ak.shape)}/{tuple(bk.shape)}, "
            f"values {tuple(av.shape)}/{tuple(bv.shape)}"
        )
    if av.device != ak.device:
        raise ValueError(f"{what}: keys on {ak.device}, values on {av.device}")
    if ak.shape[0] > 1 and (_row_stride(av) != _row_stride(ak) or _row_stride(bv) != _row_stride(bk)):
        raise ValueError(f"{what}: values must have their keys' row strides")


def _check_lens(what: str, lens: torch.Tensor, rows: torch.Tensor) -> None:
    if lens.dtype != torch.int32 or tuple(lens.shape) != (rows.shape[0],) or not lens.is_contiguous():
        raise ValueError(f"{what}: lengths must be a contiguous ({rows.shape[0]},) int32 tensor, "
                         f"got {lens.dtype} {tuple(lens.shape)}")
    if lens.device != rows.device:
        raise ValueError(f"{what}: lengths on {lens.device}, rows on {rows.device}")


def merge_batched_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: :func:`repro_torch.core.merge_batched`."""
    return _bat.merge_batched(a, b)


def merge_batched(a: torch.Tensor, b: torch.Tensor, *, tile: int = DEFAULT_TILE, leaf: int = DEFAULT_LEAF) -> torch.Tensor:
    """Stable A-priority merge of ``B`` pairs of sorted rows (K5).

    ``a`` is ``(B, na)``, ``b`` is ``(B, nb)``, one key dtype as in
    :func:`merge`; each may be a view with any row stride whose elements
    are adjacent.  Returns the contiguous ``(B, na + nb)`` merged rows.  A
    CUDA tensor launches the kernel (counted in ``merge_batched.launches``):
    K1's segment merge per row, :data:`MERGE_ROWS_SPAN` outputs of a row per
    block, whatever ``tile`` and ``leaf`` (checked, and kept for the
    reference's signature); a CPU tensor takes :func:`merge_batched_ref`.
    """
    _check_rows("merge_batched", a, b, tile, MERGE_KEY_DTYPES)
    if not _on_card("merge_batched", a):
        return merge_batched_ref(a, b)
    (bsz, na), nb = a.shape, b.shape[1]
    out = torch.empty((bsz, na + nb), dtype=a.dtype, device=a.device)
    if out.numel():
        _launch("merge_batched", "merge", "merge_batched", a.dtype, a.device,
                a.data_ptr(), na, a.stride(0), b.data_ptr(), nb, b.stride(0), out.data_ptr(), na + nb,
                bsz, tile, _leaf(tile, leaf))
        merge_batched.launches += 1
    return out


merge_batched.launches = 0


def merge_kv_batched_ref(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K6: :func:`repro_torch.core.merge_kv_batched`."""
    return _bat.merge_kv_batched(ak, av, bk, bv)


def merge_kv_batched(
    ak: torch.Tensor,
    av: torch.Tensor,
    bk: torch.Tensor,
    bv: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    leaf: int = DEFAULT_LEAF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value merge of ``B`` pairs of sorted rows (K6).

    Keys as in :func:`merge_batched`; values int32 or float32, one dtype,
    with their keys' shapes and row strides (each array may start at any
    element).  Returns the merged ``(keys, values)``.  A CUDA tensor
    launches the kernel (counted in ``merge_kv_batched.launches``): K2's
    segment merge per row, :data:`MERGE_ROWS_KV_SPAN` outputs of a row per
    block, whatever ``tile`` and ``leaf`` (checked, and kept for the
    reference's signature); a CPU tensor takes :func:`merge_kv_batched_ref`.
    """
    _check_row_values("merge_kv_batched", ak, av, bk, bv, tile)
    if not _on_card("merge_kv_batched", ak):
        return merge_kv_batched_ref(ak, av, bk, bv)
    (bsz, na), nb = ak.shape, bk.shape[1]
    ko = torch.empty((bsz, na + nb), dtype=ak.dtype, device=ak.device)
    vo = torch.empty((bsz, na + nb), dtype=av.dtype, device=ak.device)
    if ko.numel():
        _launch("merge_kv_batched", "merge", "merge_kv_batched", ak.dtype, ak.device,
                ak.data_ptr(), av.data_ptr(), na, ak.stride(0), bk.data_ptr(), bv.data_ptr(), nb, bk.stride(0),
                ko.data_ptr(), vo.data_ptr(), na + nb, bsz, tile, _leaf(tile, leaf))
        merge_kv_batched.launches += 1
    return ko, vo


merge_kv_batched.launches = 0


def merge_batched_ragged_ref(a: torch.Tensor, b: torch.Tensor, a_lens, b_lens) -> torch.Tensor:
    """Plain version of K7: :func:`repro_torch.core.merge_batched_ragged`."""
    return _bat.merge_batched_ragged(a, b, a_lens, b_lens)


def merge_batched_ragged(
    a: torch.Tensor,
    b: torch.Tensor,
    a_lens: torch.Tensor,
    b_lens: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    leaf: int = DEFAULT_LEAF,
) -> torch.Tensor:
    """Ragged stable merge of ``B`` pairs of rows (K7).

    Rows as in :func:`merge_batched`; ``a_lens`` and ``b_lens`` are ``(B,)``
    int32 on the rows' device.  The kernel clamps each length to ``[0,
    na]`` (``[0, nb]``) and never reads past it.  Row ``r`` of the result
    starts with the merge of ``a[r, :a_lens[r]]`` and ``b[r, :b_lens[r]]``,
    followed by sentinel keys.  A CUDA tensor launches the kernel (counted
    in ``merge_batched_ragged.launches``), blocked as :func:`merge_batched`'s;
    a CPU tensor takes :func:`merge_batched_ragged_ref`.
    """
    _check_rows("merge_batched_ragged", a, b, tile, MERGE_KEY_DTYPES)
    _check_lens("merge_batched_ragged", a_lens, a)
    _check_lens("merge_batched_ragged", b_lens, a)
    if not _on_card("merge_batched_ragged", a):
        return merge_batched_ragged_ref(a, b, a_lens, b_lens)
    (bsz, na), nb = a.shape, b.shape[1]
    out = torch.empty((bsz, na + nb), dtype=a.dtype, device=a.device)
    if out.numel():
        _launch("merge_batched_ragged", "merge", "merge_batched_ragged", a.dtype, a.device,
                a.data_ptr(), na, a.stride(0), a_lens.data_ptr(), b.data_ptr(), nb, b.stride(0), b_lens.data_ptr(),
                out.data_ptr(), na + nb, bsz, tile, _leaf(tile, leaf))
        merge_batched_ragged.launches += 1
    return out


merge_batched_ragged.launches = 0


def merge_kv_batched_ragged_ref(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor, a_lens, b_lens
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8: :func:`repro_torch.core.merge_kv_batched_ragged`."""
    return _bat.merge_kv_batched_ragged(ak, av, bk, bv, a_lens, b_lens)


def merge_kv_batched_ragged(
    ak: torch.Tensor,
    av: torch.Tensor,
    bk: torch.Tensor,
    bv: torch.Tensor,
    a_lens: torch.Tensor,
    b_lens: torch.Tensor,
    *,
    tile: int = DEFAULT_TILE,
    leaf: int = DEFAULT_LEAF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged stable key-value merge of ``B`` pairs of rows (K8).

    Operands as in :func:`merge_kv_batched`, lengths as in
    :func:`merge_batched_ragged` (clamped by the kernel, which never reads
    past them).  Past each row's merged length the keys are sentinel and
    the values zero.  A CUDA tensor launches the kernel (counted in
    ``merge_kv_batched_ragged.launches``), blocked as
    :func:`merge_kv_batched`'s; a CPU tensor takes
    :func:`merge_kv_batched_ragged_ref`.
    """
    _check_row_values("merge_kv_batched_ragged", ak, av, bk, bv, tile)
    _check_lens("merge_kv_batched_ragged", a_lens, ak)
    _check_lens("merge_kv_batched_ragged", b_lens, ak)
    if not _on_card("merge_kv_batched_ragged", ak):
        return merge_kv_batched_ragged_ref(ak, av, bk, bv, a_lens, b_lens)
    (bsz, na), nb = ak.shape, bk.shape[1]
    ko = torch.empty((bsz, na + nb), dtype=ak.dtype, device=ak.device)
    vo = torch.empty((bsz, na + nb), dtype=av.dtype, device=ak.device)
    if ko.numel():
        _launch("merge_kv_batched_ragged", "merge", "merge_kv_batched_ragged", ak.dtype, ak.device,
                ak.data_ptr(), av.data_ptr(), na, ak.stride(0), a_lens.data_ptr(),
                bk.data_ptr(), bv.data_ptr(), nb, bk.stride(0), b_lens.data_ptr(),
                ko.data_ptr(), vo.data_ptr(), na + nb, bsz, tile, _leaf(tile, leaf))
        merge_kv_batched_ragged.launches += 1
    return ko, vo


merge_kv_batched_ragged.launches = 0

WRAPPERS = (merge, merge_kv, sort_round, sort_round_kv, merge_batched, merge_kv_batched,
            merge_batched_ragged, merge_kv_batched_ragged, sort_tiles, sort_tiles_kv)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
