"""Device resolution shared by the port's entry points, and the DTensor test
that the core code and the parallel layer share."""

from __future__ import annotations

import sys

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` unless the caller names another device; never a silent CPU.

    With no argument the port runs on the card.  When there is no card it
    raises instead of carrying on on the CPU: the CPU is taken only when
    the caller asks for it (``device="cpu"``), as the tests do.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing the DTensor package)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)
