"""Merge Path (Green, Odeh & Birk 2014): key transforms, Algorithm 2, merges.

The PyTorch counterpart of the reference's ``repro.core.merge_path``: the
rank merges, the paper's Algorithm 1, and the merge sort and top-k built
on them.
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
from typing import Tuple

import torch

__all__ = [
    "max_sentinel",
    "min_sentinel",
    "flip_desc",
    "total_order_keys",
    "bisect",
    "bisect_steps",
    "diagonal_intersections",
    "result_type",
    "merge",
    "merge_kv",
    "partitioned_merge",
    "merge_sort",
    "merge_sort_kv",
    "stable_argsort",
    "topk_desc",
    "topk",
]

_INT_OF_WIDTH = {2: torch.int16, 4: torch.int32, 8: torch.int64}

# The dtype of a merge of two different dtypes, as ``jnp.result_type`` gives
# it for the dtypes the port takes (an int with a float gives the float).
_PROMOTE = {
    frozenset((torch.int16, torch.int32)): torch.int32,
    frozenset((torch.int16, torch.bfloat16)): torch.bfloat16,
    frozenset((torch.int32, torch.bfloat16)): torch.bfloat16,
    frozenset((torch.int16, torch.float32)): torch.float32,
    frozenset((torch.int32, torch.float32)): torch.float32,
    frozenset((torch.bfloat16, torch.float32)): torch.float32,
}


def result_type(a: torch.dtype, b: torch.dtype) -> torch.dtype:
    """The common dtype of a merge of ``a`` and ``b`` keys (or values).

    Equal dtypes stay.  Two different dtypes among int16, int32, bfloat16
    and float32 promote as JAX promotes them; any other pair raises, since
    PyTorch's and JAX's promotion rules differ outside that table.
    """
    if a == b:
        return a
    out = _PROMOTE.get(frozenset((a, b)))
    if out is None:
        raise TypeError(f"no promotion rule for merging {a} with {b}; cast the operands to one dtype")
    return out


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


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge of two sorted 1-D arrays: the flat rank-based form.

    Every element's output position is its cross-rank: ``rank(A[i]) = i +
    |{j : B[j] < A[i]}|`` and ``rank(B[j]) = j + |{i : A[i] <= B[j]}|``,
    the cross diagonal on which the Merge Path consumes it.  The
    comparisons are the raw ``<`` and ``<=`` of the dtype, so ``-0.0`` and
    ``+0.0`` tie and A's comes first.  The one-row case of
    :func:`repro_torch.core.merge_batched`.
    """
    from .batched import merge_batched  # batched builds on this module

    return merge_batched(a[None, :], b[None, :])[0]


def merge_kv(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value merge: returns the merged ``(keys, values)``.  The
    one-row case of :func:`repro_torch.core.merge_kv_batched`."""
    from .batched import merge_kv_batched  # batched builds on this module

    keys, vals = merge_kv_batched(ak[None, :], av[None, :], bk[None, :], bv[None, :])
    return keys[0], vals[0]


def partitioned_merge(a: torch.Tensor, b: torch.Tensor, p: int) -> torch.Tensor:
    """Algorithm 1 of the paper: ``p`` independent segment merges.

    The output is cut into ``p`` segments at equispaced cross diagonals;
    each "core" finds its ``(a_start, b_start)`` by the diagonal binary
    search and then runs the sequential two-pointer merge for
    ``ceil(N / p)`` steps.  The ``p`` cores are the batch axis of one loop
    over the segment length.  The last segment may be short: its diagonal
    is clamped to ``N`` and the overrun trimmed.
    """
    na, nb = a.shape[0], b.shape[0]
    n = na + nb
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    dtype = result_type(a.dtype, b.dtype)
    if na == 0:
        return b.to(dtype)
    if nb == 0:
        return a.to(dtype)
    seg = -(-n // p)  # ceil-div: the last segment may be short
    diags = torch.clamp(torch.arange(p, dtype=torch.int32, device=a.device) * seg, max=n)
    ai = diagonal_intersections(a, b, diags).long()
    bi = diags.long() - ai
    a, b = a.to(dtype), b.to(dtype)
    out = torch.empty((p, seg), dtype=dtype, device=a.device)
    for s in range(seg):
        av = a[torch.clamp(ai, max=na - 1)]
        bv = b[torch.clamp(bi, max=nb - 1)]
        take_a = (bi >= nb) | ((ai < na) & (av <= bv))
        out[:, s] = torch.where(take_a, av, bv)
        ai = ai + take_a
        bi = bi + ~take_a
    return out.reshape(-1)[:n]


def merge_sort(x: torch.Tensor) -> torch.Tensor:
    """Bottom-up merge sort from pairwise Merge Path merges: ``log2 N``
    rounds, each one fused batched merge of all pairs of runs.  The
    singleton-batch case of :func:`repro_torch.core.merge_sort_batched`."""
    from .batched import merge_sort_batched  # batched builds on this module

    if x.shape[0] <= 1:
        return x
    return merge_sort_batched(x[None, :])[0]


def merge_sort_kv(keys: torch.Tensor, values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable bottom-up key-value merge sort (keys ascending)."""
    from .batched import merge_sort_kv_batched  # batched builds on this module

    if keys.shape[0] <= 1:
        return keys, values
    ks, vs = merge_sort_kv_batched(keys[None, :], values[None, :])
    return ks[0], vs[0]


def stable_argsort(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort (ascending, int32) via the key-value merge sort."""
    _, perm = merge_sort_kv(keys, torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device))
    return perm


def topk_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, int32 indices)`` of the ``k`` largest elements, descending
    and stable: among equal values the smallest index wins."""
    perm = stable_argsort(flip_desc(x))
    top_idx = perm[:k]
    return x[top_idx.long()], top_idx


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alias of :func:`topk_desc` (descending top-k)."""
    return topk_desc(x, k)
