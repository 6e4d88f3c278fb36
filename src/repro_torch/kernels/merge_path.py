"""Flat merge-sort rounds on the hand-written Hopper kernel (K4).

The counterpart of the reference's ``sort_round_kv_pallas``
(``repro/kernels/merge_path.py``).  The sort keeps one flat buffer of
``m + tile`` elements: ``m`` data elements in sorted runs of ``width``,
then ``tile`` sentinel keys with zero values.  One round merges each pair
of runs into a run of ``2 * width`` and returns the same layout.

:func:`sort_round_kv` launches ``csrc/sort_round_kv.cu`` on a CUDA tensor
and raises if the launch fails; on a CPU tensor it runs the plain version
:func:`sort_round_kv_ref`.  There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.core.merge_path import max_sentinel

from . import _build
from .ref import sort_kv_ref

DEFAULT_TILE = 512
DEFAULT_LEAF = 32
KEY_DTYPES = (torch.int16, torch.int32)

_SYMBOL = {torch.int16: "sort_round_kv_i16", torch.int32: "sort_round_kv_i32"}


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


def _check_round(kf: torch.Tensor, vf: torch.Tensor, width: int, tile: int) -> int:
    """Validate one round's operands; returns ``m``, the data length."""
    if kf.dtype not in KEY_DTYPES:
        raise TypeError(f"sort_round_kv: keys must be int16 or int32, got {kf.dtype}")
    if vf.dtype != torch.int32:
        raise TypeError(f"sort_round_kv: values must be int32, got {vf.dtype}")
    if kf.ndim != 1 or vf.shape != kf.shape:
        raise ValueError(f"sort_round_kv: expected equal 1-D keys and values, got {tuple(kf.shape)} and {tuple(vf.shape)}")
    if kf.device != vf.device:
        raise ValueError(f"sort_round_kv: keys on {kf.device}, values on {vf.device}")
    if not (kf.is_contiguous() and vf.is_contiguous()):
        raise ValueError("sort_round_kv: keys and values must be contiguous")
    if not (_is_pow2(width) and _is_pow2(tile)) or (2 * width) % tile:
        raise ValueError(f"sort_round_kv: need power-of-two width and tile with tile | 2*width, got width={width} tile={tile}")
    m = kf.shape[0] - tile
    if m <= 0 or m % (2 * width):
        raise ValueError(f"sort_round_kv: data length {m} is not a positive multiple of 2*width={2 * width}")
    return m


def sort_round_kv_ref(
    kf: torch.Tensor, vf: torch.Tensor, width: int, *, tile: int = DEFAULT_TILE
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one round: a stable ``torch.sort`` of each pair.

    A stable sort of ``[A; B]`` is exactly the A-priority merge of two
    sorted runs.  The values follow the keys' permutation; the tail is
    rewritten with sentinel keys and zero values.
    """
    m = _check_round(kf, vf, width, tile)
    pairs = m // (2 * width)
    ks, vs = sort_kv_ref(kf[:m].view(pairs, 2 * width), vf[:m].view(pairs, 2 * width))
    tail_k = torch.full((tile,), max_sentinel(kf.dtype), dtype=kf.dtype, device=kf.device)
    tail_v = torch.zeros((tile,), dtype=vf.dtype, device=vf.device)
    return torch.cat([ks.reshape(-1), tail_k]), torch.cat([vs.reshape(-1), tail_v])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("sort_round_kv")
    for sym in _SYMBOL.values():
        fn = getattr(lib, sym)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def sort_round_kv(
    kf: torch.Tensor,
    vf: torch.Tensor,
    width: int,
    *,
    tile: int = DEFAULT_TILE,
    leaf: int = DEFAULT_LEAF,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bottom-up key-value merge-sort round on the flat padded layout.

    ``kf`` (int16 or int32) and ``vf`` (int32) are ``(m + tile,)``: runs of
    ``width`` sorted keys, then ``tile`` sentinels.  ``width`` and ``tile``
    are powers of two with ``tile | 2 * width``, and ``m`` is a multiple of
    ``2 * width`` (a flat batch of power-of-two rows qualifies).  ``leaf``
    is the kernel's level-2 leaf width S; the result does not depend on it.
    Returns new ``(keys, values)`` holding runs of ``2 * width``.

    A CUDA tensor launches the kernel (and counts one in
    ``sort_round_kv.launches``); a CPU tensor takes
    :func:`sort_round_kv_ref`.
    """
    m = _check_round(kf, vf, width, tile)
    if kf.device.type == "cpu":
        return sort_round_kv_ref(kf, vf, width, tile=tile)
    if kf.device.type != "cuda":
        raise ValueError(f"sort_round_kv: unsupported device {kf.device}")
    leaf = max(1, min(int(leaf), tile))
    lib = _library()
    ko = torch.empty_like(kf)
    vo = torch.empty_like(vf)
    with torch.cuda.device(kf.device):
        stream = torch.cuda.current_stream(kf.device).cuda_stream
        err = getattr(lib, _SYMBOL[kf.dtype])(
            kf.data_ptr(), vf.data_ptr(), ko.data_ptr(), vo.data_ptr(),
            width, tile, leaf, m // tile, stream,
        )
    if err:
        raise RuntimeError(
            f"sort_round_kv launch failed: {lib.repro_cuda_error_string(err).decode()} (cudaError {err})"
        )
    sort_round_kv.launches += 1
    return ko, vo


sort_round_kv.launches = 0
