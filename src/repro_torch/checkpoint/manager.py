"""Checkpointing: atomic, async, keep-N, in the reference's on-disk layout.

The counterpart of the reference's ``repro/checkpoint/manager.py``.  Layout
per step::

    <dir>/step_<k>.tmp/...   (written)
    <dir>/step_<k>/          (atomic rename on completion)
        manifest.json        {step, leaves: {path: {shape, dtype}}}
        arrays.npz           flat leaf path -> array

A leaf's path is its dict keys joined by ``/`` (``params/embed/table``,
``opt/m/layers/mamba/in_proj``, ``step``), as the reference names them, so
a checkpoint written by one package is restored by the other.

* **atomic**: a crashed writer never leaves a loadable-but-corrupt step;
  restore picks the newest complete directory.
* **async**: ``save(..., blocking=False)`` copies the state to host memory
  and writes it in a daemon thread while the loop keeps stepping.
* **keep-N**: only the newest ``keep`` steps stay.
* **elastic**: ``restore(..., shardings=...)`` distributes each leaf onto
  any mesh (another rank count or layout than the writer's): the restart
  path after losing hosts (:func:`repro_torch.runtime.plan_elastic_mesh`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

_SEP = "/"


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Host copies of the leaves, keyed by path.  bfloat16 has no numpy
    dtype, so it is refused (the train state holds none)."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + _SEP))
        else:
            t = torch.as_tensor(v)
            if t.dtype == torch.bfloat16:
                raise TypeError(f"checkpoint: {key} is bfloat16, which numpy cannot hold")
            flat[key] = t.detach().cpu().numpy().copy()
    return flat


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- write ---------------------------------------------------------
    def save(self, step: int, state: Dict, blocking: bool = True) -> None:
        flat = _flatten(state)  # the device-to-host copy happens here
        if blocking:
            self._write(step, flat)
        else:
            self.wait()
            self._thread = threading.Thread(target=self._write_guarded, args=(step, flat), daemon=True)
            self._thread.start()

    def _write_guarded(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        try:
            self._write(step, flat)
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Wait for an async write; raise if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- read ----------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict, step: Optional[int] = None, shardings: Optional[Dict] = None) -> Dict:
        """A state in the layout of ``like`` (a dict tree of tensors) from
        step ``step`` (the newest by default), each leaf on the device of
        ``like``'s.  Shapes must match; dtypes are the checkpoint's.

        With ``shardings``, a tree in ``like``'s layout of ``(mesh,
        placements)`` pairs (or :class:`repro_torch.parallel.sharding.NamedSharding`),
        each leaf is instead a DTensor on its mesh, which may differ from
        the writer's: every rank reads the whole array and keeps its own
        shard, with no collective (the reference's ``device_put``)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        with np.load(os.path.join(self.dir, f"step_{step}", "arrays.npz")) as data:

            def walk(node, prefix, sh):
                out = {}
                for k, v in node.items():
                    key = f"{prefix}{k}"
                    if isinstance(v, dict):
                        out[k] = walk(v, key + _SEP, None if sh is None else sh[k])
                        continue
                    arr = data[key]
                    if tuple(arr.shape) != tuple(v.shape):
                        raise ValueError(f"shape mismatch for {key}: ckpt {arr.shape} vs state {tuple(v.shape)}")
                    t = torch.from_numpy(np.array(arr))
                    out[k] = t.to(v.device) if sh is None else _distribute(t, sh[k])
                return out

            def _distribute(t, sharding):
                from torch.distributed.tensor import distribute_tensor

                mesh, placements = sharding[0], sharding[1]
                return distribute_tensor(t.to(mesh.device_type), mesh, placements, src_data_rank=None)

            return walk(like, "", shardings)
