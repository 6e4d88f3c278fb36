"""Stable ``torch.sort`` oracles for the Merge Path kernels.

They use no Merge Path machinery, so a fault in a kernel or in the core
merges cannot be mirrored here.  A stable sort of the concatenation
``[A; B]`` of two sorted runs keeps A's elements ahead of B's among equal
keys: exactly the A-priority merge.

Integer keys only, for the merges: ``torch.sort`` of floats may order
``-0.0`` and ``+0.0`` by their bits on the card, where the merges keep
A's zero first whatever its sign.  The plain versions of the merge
kernels are therefore the rank merges of :mod:`repro_torch.core`, not
these oracles.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.merge_path import result_type


def merge_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stable merge oracle (keys only): a sort of the concatenation."""
    dtype = result_type(a.dtype, b.dtype)
    return torch.sort(torch.cat([a.to(dtype), b.to(dtype)]), stable=True).values


def merge_kv_ref(
    ak: torch.Tensor, av: torch.Tensor, bk: torch.Tensor, bv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value merge oracle with A-priority."""
    kd = result_type(ak.dtype, bk.dtype)
    vd = result_type(av.dtype, bv.dtype)
    return sort_kv_ref(torch.cat([ak.to(kd), bk.to(kd)]), torch.cat([av.to(vd), bv.to(vd)]))


def sort_ref(x: torch.Tensor) -> torch.Tensor:
    """Stable sort along the last axis."""
    return torch.sort(x, dim=-1, stable=True).values


def sort_kv_ref(keys: torch.Tensor, values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value sort along the last axis."""
    ks, perm = torch.sort(keys, dim=-1, stable=True)
    return ks, torch.gather(values, -1, perm)
