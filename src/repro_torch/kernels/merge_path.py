"""The Merge Path kernels written by hand for Hopper, with their plain versions.

The counterparts of the reference's Pallas entry points
(``repro/kernels/merge_path.py``):

* :func:`merge` (K1, ``merge_pallas``) and :func:`merge_kv` (K2,
  ``merge_kv_pallas``): stable A-priority merges of two sorted 1-D arrays,
  ``csrc/merge.cu``;
* :func:`sort_round` (K3, ``sort_round_pallas``) and :func:`sort_round_kv`
  (K4, ``sort_round_kv_pallas``): one flat merge-sort round,
  ``csrc/sort_round.cu`` and ``csrc/sort_round_kv.cu``.

All four share the tile body of ``csrc/merge_tile.cuh``.  A sort keeps one
flat buffer of ``m + tile`` elements: ``m`` data elements in sorted runs of
``width``, then ``tile`` sentinel keys (with zero values).  One round
merges each pair of runs into a run of ``2 * width`` and returns the same
layout.

Each wrapper launches its kernel on a CUDA tensor (and counts the launch
in ``<wrapper>.launches``) and raises if the launch fails; on a CPU tensor
it runs the plain version beside it (``merge_ref``, ``merge_kv_ref``,
``sort_round_ref``, ``sort_round_kv_ref``).  There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import merge_path as _mp

from . import _build
from .ref import sort_kv_ref, sort_ref

DEFAULT_TILE = 512
DEFAULT_LEAF = 32
MAX_TILE = 4096  # K2's windows at 4-byte keys: 64 KB of shared memory
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
}


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
    ``<=``.  The kernel writes one ``tile`` of outputs per block, split into
    leaves of ``leaf``; the result does not depend on either.  Returns the
    ``na + nb`` merged keys.

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
    per key.  Returns the merged ``(keys, values)``.  A CUDA tensor
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


def _check_round(what: str, kf: torch.Tensor, width: int, tile: int, vf: Optional[torch.Tensor] = None) -> int:
    """Validate one round's operands; returns ``m``, the data length."""
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
    ``leaf`` is the kernel's level-2 leaf width; the result does not depend
    on it.  Returns new keys holding runs of ``2 * width``.

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
    Returns new ``(keys, values)`` holding runs of ``2 * width``.

    A CUDA tensor launches the kernel (and counts one in
    ``sort_round_kv.launches``); a CPU tensor takes
    :func:`sort_round_kv_ref`.
    """
    m = _check_round("sort_round_kv", kf, width, tile, vf)
    if not _on_card("sort_round_kv", kf):
        return sort_round_kv_ref(kf, vf, width, tile=tile)
    ko = torch.empty_like(kf)
    vo = torch.empty_like(vf)
    _launch("sort_round_kv", "sort_round_kv", "sort_round_kv", kf.dtype, kf.device,
            kf.data_ptr(), vf.data_ptr(), ko.data_ptr(), vo.data_ptr(), width, tile, _leaf(tile, leaf), m // tile)
    sort_round_kv.launches += 1
    return ko, vo


sort_round_kv.launches = 0

WRAPPERS = (merge, merge_kv, sort_round, sort_round_kv)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0
