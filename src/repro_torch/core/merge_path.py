"""Merge Path (Green, Odeh & Birk 2014): key transforms and Algorithm 2.

The PyTorch counterpart of the reference's ``repro.core.merge_path``.
Merging sorted arrays A and B is a monotone staircase path on the
|A| x |B| grid; its intersection with cross diagonal ``d`` is found by a
binary search of ``O(log min(|A|, |B|))`` steps (Theorem 14).

Conventions, as in the reference:

* arrays are sorted ascending;
* merges are **stable with A-priority**: on ties, elements of A precede
  elements of B;
* ``diagonal_intersections(a, b, d)`` returns ``ai``, the number of
  elements of A among the first ``d`` outputs of the merge; ``bi = d - ai``;
* index results are int32.  They are widened to int64 only where
  ``torch.gather``/``scatter`` take them.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "max_sentinel",
    "min_sentinel",
    "flip_desc",
    "total_order_keys",
    "bisect",
    "bisect_steps",
    "diagonal_intersections",
]

_INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def max_sentinel(dtype: torch.dtype):
    """Largest value of ``dtype`` (``+inf`` for floats), used to pad sorted runs.

    Floats use ``+inf`` rather than ``finfo.max`` so that real ``+inf``
    payloads tie with the padding; stability then keeps every real element
    ahead of the pads, which are always appended last.  The same argument
    covers int payloads equal to ``iinfo.max``.
    """
    if dtype.is_floating_point:
        return math.inf
    return torch.iinfo(dtype).max


def min_sentinel(dtype: torch.dtype):
    """Smallest value of ``dtype`` (``-inf`` / ``iinfo.min``)."""
    if dtype.is_floating_point:
        return -math.inf
    return torch.iinfo(dtype).min


def flip_desc(x: torch.Tensor) -> torch.Tensor:
    """Strictly order-reversing key transform: ``x < y  <=>  flip(x) > flip(y)``.

    Floats negate.  Ints use bitwise NOT (``~x == -x - 1``), an exact
    order-reversing bijection with no overflow at ``iinfo.min`` (where
    ``-x`` would wrap).  A stable ascending sort of flipped keys is a
    stable descending sort of the originals.
    """
    if x.is_floating_point():
        return -x
    return torch.bitwise_not(x)


def total_order_keys(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 total-order keys: same-width signed ints whose order refines
    the float order.

    1. canonicalize: ``-0.0 -> +0.0`` and every NaN to the canonical quiet
       NaN, so floats that compare equal get equal keys;
    2. reinterpret the bits as the same-width signed int ``i``
       (bf16/f16 -> int16, f32 -> int32);
    3. ``key = i`` for nonnegative floats, ``key = iinfo.min ^ ~i`` for
       negative ones.

    Resulting order: ``-inf < ... < -0.0 == +0.0 < ... < +inf < NaN``.
    Every key lies strictly inside ``(iinfo.min, iinfo.max)``, so the int
    sentinels still bracket every real key.  Int inputs are returned as
    they are.
    """
    if not x.is_floating_point():
        return x
    int_dtype = _INT_OF_WIDTH[x.element_size()]
    x = x.detach()
    canon_nan = torch.full((), math.nan, dtype=x.dtype, device=x.device)
    x = torch.where(torch.isnan(x), canon_nan, x + 0.0)  # +0 folds -0.0 -> +0.0
    bits = x.contiguous().view(int_dtype)
    imin = torch.iinfo(int_dtype).min
    return torch.where(bits < 0, torch.bitwise_xor(torch.bitwise_not(bits), imin), bits)


def bisect_steps(span: int) -> int:
    """Fixed trip count that makes a bisection over ``span + 1`` cells converge."""
    return max(1, int(math.ceil(math.log2(span + 1))) + 1)


def bisect(lo: torch.Tensor, hi: torch.Tensor, steps: int, probe) -> torch.Tensor:
    """Fixed-trip bisection shared by the Algorithm 2 searches:
    ``probe(mid)`` is True where ``A[mid]`` precedes ``B[d - 1 - mid]``
    (A-priority: ``A[i] <= B[j]``).  Returns the first index where it fails."""
    for _ in range(steps):
        mid = (lo + hi) >> 1
        pred = probe(mid)
        active = lo < hi
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def diagonal_intersections(a: torch.Tensor, b: torch.Tensor, diags: torch.Tensor) -> torch.Tensor:
    """Vectorized Algorithm 2 of the paper.

    For every cross diagonal ``d`` in ``diags`` (ints in ``[0, |A|+|B|]``)
    returns ``ai`` with ``0 <= ai <= |A|`` such that the first ``d``
    outputs of the stable merge are ``A[:ai]`` and ``B[:d-ai]``.  All
    diagonals are searched at once with a fixed trip count.  The probes
    are clipped into range explicitly: torch indexing raises on an
    out-of-range index where the reference's gathers clamp.
    """
    na, nb = a.shape[0], b.shape[0]
    diags = torch.as_tensor(diags, dtype=torch.int32, device=a.device)
    if nb == 0:  # path is a straight vertical line
        return torch.clamp(diags, max=na)
    if na == 0:  # straight horizontal line
        return torch.zeros_like(diags)

    def probe(mid):
        return a[torch.clamp(mid, 0, na - 1).long()] <= b[torch.clamp(diags - 1 - mid, 0, nb - 1).long()]

    lo = torch.clamp(diags - nb, min=0)
    hi = torch.clamp(diags, max=na)
    return bisect(lo, hi, bisect_steps(min(na, nb)), probe)
