"""Weights and train states between the reference's trees and the port's.

The port keeps the reference's parameter structure (nested dicts, layer
parameters stacked on a leading ``num_layers`` axis) and its train state
(``{"step", "params", "opt": {"m", "v"}}``), so conversion is a one-to-one
map of leaves.  The caller hands over the tree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``), and :func:`to_numpy` gives
the port's trees back as numpy; this module imports nothing of the
reference.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig


def _to_tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the port's tensors never alias the caller's arrays
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: move the bits as int16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_jax_params(
    cfg: ModelConfig, tree: Dict, device: Optional[Union[str, torch.device]] = None
) -> Dict:
    """The reference's parameter tree (numpy leaves) as port parameters on ``device``.

    Every leaf keeps its dtype: a MoE layer's ``moe`` leaves carry over as
    they are, the router in float32 beside bfloat16 experts, as the
    reference's tree has it; a VLM's ``prefix_proj``, an audio model's
    ``encoder`` and its decoder layers' ``cross`` too."""
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


def from_jax_train_state(
    cfg: ModelConfig, tree: Dict[str, Any], device: Optional[Union[str, torch.device]] = None
) -> Dict[str, Any]:
    """The reference's train state (numpy leaves: ``step``, the float32
    masters ``params`` and the moments ``opt["m"]``, ``opt["v"]``, and the
    compression's error state ``err`` when it has one) as the port's, on
    ``device``, ready for ``make_train_step``."""
    dev = resolve_device(device)
    params = from_jax_params(cfg, tree["params"], device=dev)

    def walk(node, like):
        if set(node) != set(like):
            raise ValueError(f"moment layout {sorted(node)} differs from the parameters' {sorted(like)}")
        return {k: walk(v, like[k]) if isinstance(v, dict) else _to_tensor(v, dev) for k, v in node.items()}

    opt = {name: walk(tree["opt"][name], params) for name in ("m", "v")}
    step = torch.tensor(np.array(tree["step"]), dtype=torch.int32).reshape(()).to(dev)
    state = {"step": step, "params": params, "opt": opt}
    if "err" in tree:
        state["err"] = walk(tree["err"], params)
    return state


def to_numpy(tree: Any) -> Any:
    """A dict tree of tensors as numpy arrays on the host (bfloat16 leaves as
    float32: numpy has no bfloat16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

