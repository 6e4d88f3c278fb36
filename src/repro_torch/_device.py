"""Device resolution shared by the port's entry points."""

from __future__ import annotations

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
