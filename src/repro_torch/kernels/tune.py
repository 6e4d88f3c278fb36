"""(tile, leaf) selection for the merges and the sort rounds.

The reference picks from a table measured in Pallas interpret mode on a
CPU, which says nothing about an H100, so the port does not carry it.
Until a table is measured on the card, :func:`pick` returns the defaults
``T = 512`` and ``S = 32`` (one warp per leaf), capped so that a small
input does not get a tile wider than itself.
"""

from __future__ import annotations

from typing import Tuple

from .merge_path import DEFAULT_LEAF, DEFAULT_TILE

MIN_TILE = 128


def pick(n: int) -> Tuple[int, int]:
    """``(tile, leaf)`` for merging ``n`` elements in total, or for sorting
    rows of ``n``; ``n`` need not be a power of two.  Tiles are powers of
    two, as the flat sort rounds need; a merge with ``n <= tile`` takes the
    core path and launches nothing."""
    cap = 1 << max(0, (max(1, n) - 1).bit_length())
    tile = min(DEFAULT_TILE, max(cap, MIN_TILE))
    return tile, min(DEFAULT_LEAF, tile)
