"""Stable ``torch.sort`` oracles for the Merge Path kernels.

They use no Merge Path machinery, so a fault in a kernel or in the core
merges cannot be mirrored here.  A stable sort of the concatenation
``[A; B]`` of two sorted runs keeps A's elements ahead of B's among equal
keys: exactly the A-priority merge.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sort_kv_ref(keys: torch.Tensor, values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable key-value sort along the last axis."""
    ks, perm = torch.sort(keys, dim=-1, stable=True)
    return ks, torch.gather(values, -1, perm)

