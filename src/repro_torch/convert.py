"""Weights from the reference's parameter tree into the port's layout.

The port keeps the reference's parameter structure (nested dicts, layer
parameters stacked on a leading ``num_layers`` axis), so conversion is a
one-to-one map of leaves.  The caller hands over the tree as numpy arrays
(for example ``jax.tree.map(np.asarray, params)``); this module imports
nothing of the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_family


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the port's tensors never alias the caller's arrays
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: move the bits as int16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_jax_params(
    cfg: ModelConfig, tree: Dict, device: Optional[Union[str, torch.device]] = None
) -> Dict:
    """The reference's parameter tree (numpy leaves) as port parameters on ``device``."""
    check_family(cfg)
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _to_tensor(node, dev)

    params = walk(tree)
    table = params["embed"]["table"]
    if tuple(table.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embedding table {tuple(table.shape)} does not match {cfg.name}")
    return params
