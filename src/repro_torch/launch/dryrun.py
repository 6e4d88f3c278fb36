"""Dry run: one step of every (arch x shape) cell on the production meshes,
as meta DTensors over a fake process group, with its memory, cost and
roofline terms.

The port's counterpart of the reference's ``repro/launch/dryrun.py``, which
lowers and compiles each cell on 256 or 512 placeholder devices and reads
XLA's memory and cost analyses.  Here one process holds a fake group of
512 ranks (``torch.distributed``'s ``fake`` backend: collectives do
nothing), builds the state or parameters and the inputs as meta DTensors
with the reference's shardings (:mod:`repro_torch.launch.specs`), and runs
``make_train_step``, ``make_prefill_step`` or ``make_decode_step`` once
eagerly under :func:`~repro_torch.parallel.sharding.sharding_env`, counting
as it goes.  Nothing is allocated and no card is touched.

What one device does is counted from its local shards:

* ``flops_per_device``: each operation with a flop formula (PyTorch's
  ``flop_counter`` registry: the products, convolutions, attention) at its
  global shapes, divided by the mesh degree of every dimension its result
  is sharded or partial over, so replicated work counts on each device;
* ``bytes_per_device``: each operation that is not a view reads its
  operands' local shards once and writes its results' once (eager
  execution: no fusion);
* ``wire_bytes_per_device``: the result bytes of every collective the
  DTensor layer issues (the redistributions of ``constrain`` and of the
  sharding propagation, forward and backward), with the reference's
  multipliers (:func:`repro_torch.launch.roofline.collective_bytes`);
* ``temp_bytes``: the peak of the live results of the step's operations
  (local shards, the arguments excluded).

Every layer runs, so ``depth_extrapolated`` is false (the reference counts
two shallow variants and extrapolates; its ``utils/costmode.py`` has no
counterpart).  A cell that stops on an operation without a DTensor
sharding rule writes ``status: "error"`` with the operation's name.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out build/dryrun]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import traceback
import weakref
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, SHAPES_BY_NAME, TrainConfig, get_config, list_archs, shape_applicable
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    batch_shardings,
    batch_specs,
    decode_shardings,
    decode_specs,
    params_shardings,
    state_shardings,
)
from repro_torch.parallel.sharding import make_rules, put_tree, sharding_env
from repro_torch.telemetry import wall_seconds
from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step

WORLD = 512  # the fake group: the multi-pod mesh, and the single pod on its first 256 ranks
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build", "dryrun")

# functional collectives (the DTensor layer's) and the reference's HLO kinds they count as
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def start_fake_group(world: int = WORLD) -> None:
    """Start a fake default group of ``world`` ranks in this process, this
    one rank 0, unless a fake group is already up; a real group raises."""
    import torch.distributed as dist

    if dist.is_initialized():
        backend = str(dist.get_backend())
        if backend != "fake":
            raise RuntimeError(f"the dry run runs on a fake process group, and a {backend!r} group is already up")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers the "fake" backend

    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())


def _local(t):
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def tree_bytes(tree) -> int:
    """The local bytes of every tensor in ``tree`` (a DTensor's shard)."""
    return sum(_nbytes(t) for t in _tensors(tree))


class StepCounter:
    """One device's flops, bytes, wire bytes and live-result peak over an
    eager step on DTensors (see the module's docstring): :meth:`modes` gives
    the two dispatch modes to enter, outermost first."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0
        self.colls = []  # (kind, result bytes)
        self.live = 0
        self.peak = 0

    def _release(self, n: int) -> None:
        self.live -= n

    def _collective(self, func, out) -> None:
        kind = _COLLECTIVES.get(func.overloadpacket.__name__) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            self.colls.append((kind, sum(_nbytes(t) for t in _tensors(out))))

    def _result(self, func, args, out) -> None:
        """Bytes of a non-view operation and the live results it adds."""
        if func.is_view:
            return
        ins = list(_tensors(args))
        outs = list(_tensors(out))
        self.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        held = {id(_local(t)) for t in ins}
        for t in outs:
            loc = _local(t)
            if id(loc) in held:  # in place
                continue
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(loc, self._release, n)

    def modes(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class GlobalOps(TorchDispatchMode):
            """Every operation on DTensors (and on plain, replicated tensors)
            at its global shapes."""

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                try:
                    out = func(*args, **kwargs)  # a collective issued here reaches LocalCollectives below
                except Exception as e:  # the operation that failed, for the record
                    if not hasattr(e, "dry_run_op"):
                        e.dry_run_op = str(func)
                    raise
                formula = flop_registry.get(func.overloadpacket)
                if formula is not None:
                    flops = formula(*args, **kwargs, out_val=out)
                    first = next(_tensors(out), None)
                    if isinstance(first, DTensor):
                        mesh = first.device_mesh
                        for i, p in enumerate(first.placements):
                            if p.is_shard() or p.is_partial():
                                flops /= mesh.size(i)
                    counter.flops += flops
                counter._result(func, (args, kwargs), out)
                return out

        class LocalCollectives(TorchDispatchMode):
            """The collectives the DTensor layer issues on local shards."""

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **(kwargs or {}))
                counter._collective(func, out)
                return out

        return LocalCollectives(), GlobalOps()


def _op_name(e: BaseException) -> Optional[str]:
    """The operation a cell stopped on: the one DTensor's message names, else
    the one being dispatched when it raised."""
    m = re.search(r"aten\.[A-Za-z0-9_]+(?:\.[A-Za-z0-9_]+)?", str(e))
    return m.group(0) if m else getattr(e, "dry_run_op", None)


def _run_step(cfg, shape, mesh, rules, tcfg: TrainConfig):
    """Build the cell's arguments as meta DTensors and run its step once:
    ``(args, out, counter, seconds)``."""
    from torch.distributed.tensor.experimental import implicit_replication

    if shape.mode == "train":
        state, st_sh = state_shardings(cfg, tcfg, mesh, rules)
        batch = put_tree(batch_specs(cfg, shape, "train"), batch_shardings(cfg, shape, "train", mesh, rules))
        args = (put_tree(state, st_sh), batch)
        step = make_train_step(cfg, tcfg)
    elif shape.mode == "prefill":
        params, p_sh = params_shardings(cfg, mesh, rules)
        batch = put_tree(batch_specs(cfg, shape, "prefill"), batch_shardings(cfg, shape, "prefill", mesh, rules))
        args = (put_tree(params, p_sh), batch)
        step = make_prefill_step(cfg)
    else:
        params, p_sh = params_shardings(cfg, mesh, rules)
        dspec = decode_specs(cfg, shape)
        d_sh = decode_shardings(cfg, shape, mesh, rules, dspec["caches"])
        args = tuple(put_tree(dspec[k], d_sh[k]) for k in ("caches", "token", "pos"))
        args = (put_tree(params, p_sh),) + args
        if cfg.is_encoder_decoder:
            args = args + (tuple(put_tree(t, s) for t, s in zip(dspec["enc_kv"], d_sh["enc_kv"])),)
        step = make_decode_step(cfg)
    counter = StepCounter()
    outer, inner = counter.modes()
    t0 = wall_seconds()
    with sharding_env(mesh, rules), implicit_replication(), outer, inner:
        out = step(*args)
    return args, out, counter, wall_seconds() - t0


def lower_cell(arch: str, shape_name: str, multi_pod: bool, tcfg: Optional[TrainConfig] = None,
               cfg_override=None, mesh=None) -> Dict[str, Any]:
    """One cell's record.  Starts the fake group if none is up; ``mesh``
    (a ``DeviceMesh``) replaces the production mesh, ``cfg_override`` the
    registered config."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "skipped", "reason": why}
    tcfg = tcfg or TrainConfig()
    start_fake_group()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.size()
    rules = make_rules(mesh, fsdp_over_pod=cfg.fsdp_over_pod, context_parallel=shape.mode == "decode")
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if shape.global_batch % math.prod(sizes[a] for a in rules.batch):  # batch-1 cells replicate the batch
        rules = dataclasses.replace(rules, batch=())
    args, out, counter, seconds = _run_step(cfg, shape, mesh, rules, tcfg)
    colls = rl.collective_bytes(counter.colls)
    wire = sum(v for k, v in colls.items() if k in rl._COLL_KINDS)
    roof = rl.Roofline(flops_per_device=counter.flops, bytes_per_device=float(counter.bytes),
                       wire_bytes_per_device=wire, collective_detail=colls, chips=chips,
                       model_flops=rl.model_flops(cfg, shape))
    return {
        "arch": arch,
        "shape": shape_name,
        "mode": shape.mode,
        "multi_pod": multi_pod,
        "chips": chips,
        "status": "ok",
        "mesh": list(mesh.shape),
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "step_s": round(seconds, 1),
        "depth_extrapolated": False,
        "memory_analysis": {"argument_bytes": tree_bytes(args), "output_bytes": tree_bytes(out),
                            "temp_bytes": counter.peak},
        "cost_module_raw": {"flops": counter.flops, "bytes accessed": float(counter.bytes), "wire_bytes": wire},
        "roofline": roof.to_dict(),
    }


def cell_filename(arch: str, shape_name: str, multi_pod: bool) -> str:
    pod = "2pod" if multi_pod else "1pod"
    return f"{arch.replace('/', '_')}__{shape_name}__{pod}.json"


def error_record(arch: str, shape_name: str, multi_pod: bool, e: BaseException) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "error", "op": _op_name(e),
            "error": f"{type(e).__name__}: {e}"[:4000], "traceback": traceback.format_exc()[-4000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=os.path.normpath(DEFAULT_OUT))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or not args.arch) else [get_config(args.arch).name]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                fname = os.path.join(args.out, cell_filename(arch, shape_name, mp))
                if args.skip_existing and os.path.exists(fname):
                    print(f"[skip existing] {fname}")
                    continue
                print(f"=== {arch} x {shape_name} ({'2pod' if mp else '1pod'}) ===", flush=True)
                try:
                    record = lower_cell(arch, shape_name, mp)
                except Exception as e:
                    record = error_record(arch, shape_name, mp, e)
                    failures += 1
                with open(fname, "w") as f:
                    json.dump(record, f, indent=1)
                if record["status"] == "ok":
                    r = record["roofline"]
                    print(f"  step {record['step_s']}s | flops/dev {r['flops_per_device']:.3e} | "
                          f"bytes/dev {r['bytes_per_device']:.3e} | wire/dev {r['wire_bytes_per_device']:.3e} | "
                          f"bottleneck {r['bottleneck']} | t_step {r['t_step_s'] * 1e3:.2f} ms", flush=True)
                elif record["status"] == "skipped":
                    print(f"  SKIPPED: {record['reason']}")
                else:
                    print(f"  ERROR ({record['op']}): {record['error'][:300]}")
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
