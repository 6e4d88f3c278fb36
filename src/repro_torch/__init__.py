"""repro_torch — the PyTorch/CUDA port of the Merge Path system.

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; a CUDA tensor goes through the hand-written Hopper
kernels (``repro_torch.kernels``), a CPU tensor through their plain
PyTorch versions.
"""

from ._device import resolve_device

__all__ = ["resolve_device"]
