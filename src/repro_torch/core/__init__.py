"""Pure-PyTorch Merge Path core: key transforms, Algorithm 2, batched merges."""

from .batched import (
    diagonal_intersections_batched,
    merge_kv_batched,
    merge_sort_kv_batched,
    searchsorted_batched,
    stable_argsort_batched,
    topk_batched,
    window_intersections,
)
from .merge_path import (
    bisect_steps,
    diagonal_intersections,
    flip_desc,
    max_sentinel,
    min_sentinel,
    total_order_keys,
)

__all__ = [
    "bisect_steps",
    "diagonal_intersections",
    "diagonal_intersections_batched",
    "flip_desc",
    "max_sentinel",
    "merge_kv_batched",
    "merge_sort_kv_batched",
    "min_sentinel",
    "searchsorted_batched",
    "stable_argsort_batched",
    "topk_batched",
    "total_order_keys",
    "window_intersections",
]
