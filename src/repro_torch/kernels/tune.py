"""(tile, leaf) selection for the merges and the sorts, and its autotuner.

The port's counterpart of the reference's ``repro/kernels/tune.py``.
``kernels.ops`` resolves an unspecified ``tile=None`` / ``leaf=None``
through :func:`pick`, which looks the call up in a table keyed by
``(dtype kind, log2-size bucket)``: the exact bucket first, then the
nearest measured bucket of the same kind, then ``(DEFAULT_TILE,
DEFAULT_LEAF)``, the tile capped so that a small input does not get a tile
wider than itself.

The reference's table was measured in Pallas interpret mode on a CPU,
which says nothing about an H100, so the port does not carry it:
``DEFAULT_TABLE`` is empty and :func:`pick` returns the defaults ``T =
512``, ``S = 32`` until a table measured on the card is installed.
:func:`autotune` measures one ``(dtype, size)`` cell and updates the
in-process table; :func:`build_table` measures the reference's grid;
``python -m repro_torch.kernels.tune`` prints it.

What the tile changes on the card: since the merges run fixed spans per
block whatever the tile (``kernels.merge_path.MERGE_SPAN`` and its
siblings), only whether a merge takes the core path (``n <= tile``); in a
sort it sets the tile sort S1's chunk and where K3's (K4's) wide rounds
begin, so the autotuner times :func:`repro_torch.kernels.ops.sort`.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import resolve_device

from .merge_path import DEFAULT_LEAF, DEFAULT_TILE, MAX_TILE

MIN_TILE = 128
TILE_CANDIDATES = tuple(1 << e for e in range(MIN_TILE.bit_length() - 1, MAX_TILE.bit_length()))  # 128 ... 4096
# No port kernel reads the leaf (each thread merges a segment; there are no
# leaves), so the autotuner has nothing to time across leaves.
LEAF_CANDIDATES = (DEFAULT_LEAF,)

# (dtype kind, log2(total elements) bucket) -> (tile, leaf); empty until a
# table measured on the card is installed (PERF.md holds the measured one).
DEFAULT_TABLE: Dict[Tuple[str, int], Tuple[int, int]] = {}

_TABLE: Dict[Tuple[str, int], Tuple[int, int]] = dict(DEFAULT_TABLE)


def _kind(dtype) -> str:
    """Collapse a dtype to the table's kind axis: ``'i'`` (ints) or ``'f'``
    (floats, bfloat16 included)."""
    return "f" if dtype.is_floating_point else "i"


def _bucket(n: int) -> int:
    return max(8, min(22, int(round(math.log2(max(2, n))))))


def pick(n: int, dtype: Optional[torch.dtype] = None) -> Tuple[int, int]:
    """``(tile, leaf)`` for merging ``n`` elements in total, or for sorting
    rows of ``n``, of ``dtype``; ``n`` need not be a power of two.

    Exact-bucket hit first, then the nearest measured bucket of the same
    dtype kind, then the module defaults (also for ``dtype=None``).  Tiles
    are powers of two, as the flat sort rounds need, capped at the next
    power of two at or above ``n`` (at least ``MIN_TILE``); a merge with
    ``n <= tile`` takes the core path and launches nothing."""
    entry = None
    if dtype is not None:
        kind, b = _kind(dtype), _bucket(n)
        entry = _TABLE.get((kind, b))
        if entry is None:
            same_kind = [(abs(kb - b), kb) for (kk, kb) in _TABLE if kk == kind]
            if same_kind:
                entry = _TABLE[(kind, min(same_kind)[1])]
    tile, leaf = entry or (DEFAULT_TILE, DEFAULT_LEAF)
    cap = 1 << max(0, (max(1, n) - 1).bit_length())
    tile = min(tile, max(cap, MIN_TILE))
    return tile, min(leaf, tile)


def _time_ms(fn, iters: int, warmup: int = 1) -> float:
    """The median of ``iters`` calls of ``fn`` in ms, after ``warmup``: CUDA
    events on the card, the telemetry wall clock on the CPU."""
    for _ in range(warmup):
        out = fn()
    on_card = isinstance(out, torch.Tensor) and out.is_cuda
    times = []
    for _ in range(iters):
        if on_card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            from repro_torch.telemetry import wall_seconds

            t0 = wall_seconds()
            fn()
            times.append((wall_seconds() - t0) * 1e3)
    return statistics.median(times)


def _probe_keys(n: int, dtype, device) -> torch.Tensor:
    """``n`` random keys of ``dtype`` from a generator seeded with ``n``."""
    gen = torch.Generator().manual_seed(n)
    if _kind(dtype) == "i":
        x = torch.randint(-(2**30), 2**30, (n,), generator=gen, dtype=torch.int64)
    else:
        x = torch.randn((n,), generator=gen)
    return x.to(dtype).to(device)


def autotune(
    n: int,
    dtype,
    *,
    tiles: Tuple[int, ...] = TILE_CANDIDATES,
    leaves: Tuple[int, ...] = LEAF_CANDIDATES,
    iters: int = 10,
    update_table: bool = True,
    device=None,
) -> Tuple[int, int]:
    """Time :func:`repro_torch.kernels.ops.sort` of ``n`` keys of ``dtype``
    at each candidate ``(tile, leaf)`` and return the fastest pair.

    The sort is what the tile changes on the card (see the module's
    docstring); tiles wider than ``n``'s next power of two are skipped.
    Each candidate is timed after one warm-up call, the median of
    ``iters``.  With ``update_table`` (default) the result is written into
    the in-process table, so :func:`pick` returns it for that bucket.
    ``device=None`` is the card, as for every entry point of the port.
    """
    from . import ops

    device = resolve_device(device)
    x = _probe_keys(n, dtype, device)
    cap = 1 << max(0, (max(1, n) - 1).bit_length())
    best, best_ms = None, float("inf")
    # the autotuner's job is exactly to launch candidates one by one
    for tile in tiles:  # lint: ok(L004)
        if tile > max(MIN_TILE, cap):  # a tile wider than the problem is noise
            continue
        for leaf in leaves:  # lint: ok(L004)
            if leaf > tile:
                continue
            ms = _time_ms(lambda t=tile, s=leaf: ops.sort(x, tile=t, leaf=s), iters)
            if ms < best_ms:
                best, best_ms = (tile, leaf), ms
    assert best is not None
    if update_table:
        _TABLE[(_kind(dtype), _bucket(n))] = best
    return best


def build_table(
    sizes: Tuple[int, ...] = (1 << 12, 1 << 15, 1 << 18),
    dtypes=(torch.float32, torch.int32),
    **kw,
) -> Dict[Tuple[str, int], Tuple[int, int]]:
    """Run :func:`autotune` over the reference's ``sizes x dtypes`` grid;
    returns the table fragment (also installed in-process)."""
    out = {}
    for dtype in dtypes:
        for n in sizes:
            out[(_kind(dtype), _bucket(n))] = autotune(n, dtype, **kw)
    return out


def format_table(table: Dict[Tuple[str, int], Tuple[int, int]]) -> str:
    """``table`` as the ``DEFAULT_TABLE`` literal it would be installed as."""
    lines = ["DEFAULT_TABLE: Dict[Tuple[str, int], Tuple[int, int]] = {"]
    lines += [f"    {k!r}: {table[k]!r}," for k in sorted(table)]
    return "\n".join(lines + ["}"])


def main() -> None:
    """Measure :func:`build_table` on the card and print it.  Without a card
    it raises: the port never times the CPU in the card's place."""
    if not torch.cuda.is_available():
        raise RuntimeError("the autotuner measures the card: no CUDA device here")
    print(format_table(build_table()))


if __name__ == "__main__":
    sys.exit(main())
