"""Parameter lattice for the kernel checker.

The port's copy of the reference's ``repro/analysis/lattice.py``.  One
:class:`LatticeConfig` is one point the checker proves the contracts at:
dtype x problem size x (tile, leaf) x batch, plus the selective scan's own
(seq, d_model, state, chunk, d_tile) axes.  The reference's ``engine``
axis is gone: it chose between two Pallas block bodies, and every port
kernel runs one (``csrc/segment_merge.cuh``).  Two lattices are drawn:

* the **model lattice** (:func:`model_lattice`): every combination the
  closed-form rules (block coverage and divisibility, window reads,
  shared memory) sweep; each point costs microseconds, so it is broad:
  sizes that divide no tile, every dtype;
* the **trace lattice** (:func:`trace_lattice`): the points pushed through
  the real wrappers on small tensors.  On a CUDA device each of them
  launches the kernels, so it samples the corners (smallest and largest
  tile, int and float keys, a size below the tile, a size no tile
  divides) rather than the whole product.

Sizes exercise the historical failure modes: ``n = 96`` (below every
tile: the core path, nothing launched), ``n = 1000`` (divisible by no
tile), ``n = 4096`` (a clean power of two).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

DTYPES = ("float32", "int32", "bfloat16")
SIZES = (96, 1000, 4096)
TILES = (128, 512)
LEAVES = (8, 32)
BATCHES = (1, 4)


@dataclass(frozen=True)
class LatticeConfig:
    """One point of the contract-checking sweep."""

    dtype: str = "float32"
    n: int = 4096  # total merged length / sorted row width
    batch: int = 4
    tile: int = 512
    leaf: int = 32
    ragged: bool = False
    k: int = 8  # top-k width
    runs: int = 4  # merge_k fan-in
    # selective-scan axes (kind="scan" ignores the merge axes above); the
    # port's scan tiles D itself (32 channels a block), so d_tile is the
    # reference's axis, kept for its points
    seq: int = 256
    d_model: int = 128
    state: int = 8
    chunk: int = 64
    d_tile: int = 64

    def with_(self, **changes) -> "LatticeConfig":
        return replace(self, **changes)

    def describe(self) -> str:
        return (
            f"dtype={self.dtype} n={self.n} batch={self.batch} tile={self.tile} "
            f"leaf={self.leaf} ragged={self.ragged}"
        )


def model_lattice() -> List[LatticeConfig]:
    """The full product for the closed-form rules (72 points)."""
    return [
        LatticeConfig(dtype=dtype, n=n, batch=batch, tile=tile, leaf=leaf)
        for dtype in DTYPES
        for n in SIZES
        for tile in TILES
        for leaf in LEAVES
        for batch in BATCHES
    ]


def trace_lattice(fast: bool = False) -> List[LatticeConfig]:
    """The corners the real wrappers run at.

    ``fast=True`` (the test suite) keeps two points; the full set adds a
    float sort at the big tile, bfloat16 keys and a size below the tile.
    """
    pts = [
        LatticeConfig(dtype="float32", n=1000, tile=128, leaf=8),
        LatticeConfig(dtype="int32", n=4096, tile=512, leaf=32),
    ]
    if not fast:
        pts += [
            LatticeConfig(dtype="float32", n=4096, tile=512, leaf=8),
            LatticeConfig(dtype="bfloat16", n=1000, tile=128, leaf=32),
            LatticeConfig(dtype="int32", n=96, tile=128, leaf=8),
        ]
    return pts


def scan_lattice(fast: bool = False) -> List[LatticeConfig]:
    """Selective-scan points: a chunk that divides the sequence, and one
    that does not (with a state width the kernel does not take: on a CUDA
    device the checker expects that point to be refused)."""
    pts = [
        LatticeConfig(dtype="float32", batch=2, seq=256, d_model=128, state=8, chunk=64, d_tile=64),
    ]
    if not fast:
        pts += [
            LatticeConfig(dtype="bfloat16", batch=1, seq=200, d_model=96, state=4, chunk=64, d_tile=64),
        ]
    return pts
