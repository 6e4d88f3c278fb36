"""Kernel layer: hand-written Hopper kernels, their plain versions, the sort surface.

Importing this package builds nothing; ``nvcc`` runs at the first launch
on a CUDA tensor (see :mod:`repro_torch.kernels._build`).  ``WRAPPERS``
lists every kernel wrapper (the merge-path kernels K1-K8, the tile sort
S1 and the selective scan's forward K9 and backward K10);
:func:`reset_launches` sets all their launch counts to 0.
"""

from . import merge_path, ops, ssm_scan
from .merge_path import (
    DEFAULT_LEAF,
    DEFAULT_TILE,
    merge,
    merge_batched,
    merge_batched_ragged,
    merge_batched_ragged_ref,
    merge_batched_ref,
    merge_kv,
    merge_kv_batched,
    merge_kv_batched_ragged,
    merge_kv_batched_ragged_ref,
    merge_kv_batched_ref,
    merge_kv_ref,
    merge_ref,
    sort_round,
    sort_round_kv,
    sort_round_kv_ref,
    sort_round_ref,
    sort_tiles,
    sort_tiles_kv,
    sort_tiles_kv_ref,
    sort_tiles_ref,
)
WRAPPERS = merge_path.WRAPPERS + (ssm_scan.ssm_scan, ssm_scan.ssm_scan_bwd)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


__all__ = [
    "DEFAULT_LEAF",
    "DEFAULT_TILE",
    "WRAPPERS",
    "merge",
    "merge_batched",
    "merge_batched_ragged",
    "merge_batched_ragged_ref",
    "merge_batched_ref",
    "merge_kv",
    "merge_kv_batched",
    "merge_kv_batched_ragged",
    "merge_kv_batched_ragged_ref",
    "merge_kv_batched_ref",
    "merge_kv_ref",
    "merge_ref",
    "ops",
    "reset_launches",
    "sort_round",
    "sort_round_kv",
    "sort_round_kv_ref",
    "sort_round_ref",
    "sort_tiles",
    "sort_tiles_kv",
    "sort_tiles_kv_ref",
    "sort_tiles_ref",
    "ssm_scan",
]
