"""Kernel layer: hand-written Hopper kernels, their plain versions, the sort surface.

Importing this package builds nothing; ``nvcc`` runs at the first launch
on a CUDA tensor (see :mod:`repro_torch.kernels._build`).
"""

from . import ops
from .merge_path import DEFAULT_LEAF, DEFAULT_TILE, sort_round_kv, sort_round_kv_ref

__all__ = ["DEFAULT_LEAF", "DEFAULT_TILE", "ops", "sort_round_kv", "sort_round_kv_ref"]
