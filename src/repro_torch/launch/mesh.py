"""Meshes: the reference's production and test meshes on ``DeviceMesh``.

The port's copy of the reference's ``repro/launch/mesh.py``.  Each is a
function (importing this module touches no process group).  The single
pod is ``(data=16, model=16)``, 256 ranks; the multi-pod mesh ``(pod=2,
data=16, model=16)``, 512.  The ranks come from the default process group,
which the caller starts: the dry run (:mod:`repro_torch.launch.dryrun`)
starts a fake one of 512 ranks in one process (``device_type="cpu"``,
meta tensors), a real launcher NCCL over its cards (``"cuda"``).
"""

from __future__ import annotations

import math

import torch


def _world() -> int:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (the dry run starts a fake group of 512 ranks) before "
                           "building a mesh")
    return dist.get_world_size()


def _mesh(device_type: str, shape, names):
    """A ``DeviceMesh`` of ``shape`` over the first ``prod(shape)`` ranks of
    the default group; this rank must be among them."""
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    n = math.prod(shape)
    world = _world()
    if world == n:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
    if world < n:
        raise RuntimeError(f"mesh {tuple(shape)} needs {n} ranks, found {world}: run it under "
                           "repro_torch.launch.dryrun, which starts a fake group of 512 ranks")
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(shape)), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``(data=16, model=16)``, or ``(pod=2, data=16, model=16)`` with
    ``multi_pod``; the single pod takes the first 256 ranks of a group of
    512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names)


def make_flat_mesh(p: int | None = None, axis: str = "x", device_type: str = "cuda"):
    """A 1-D mesh over the first ``p`` ranks (all of them when None), the
    one dimension named ``axis``: the layout the distributed Merge Path
    functions (``repro_torch.core.distributed``) run over."""
    world = _world()
    if p is None:
        p = world
    if world < p:
        raise RuntimeError(f"need {p} ranks, have {world}")
    return _mesh(device_type, (p,), (axis,))


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str = "cpu"):
    """A small ``(data, model)`` mesh for tests on gloo or fake ranks."""
    world = _world()
    if world < data * model:
        raise RuntimeError(f"need {data * model} ranks, have {world}")
    return _mesh(device_type, (data, model), ("data", "model"))
