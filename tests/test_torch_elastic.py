"""Fault tolerance and elastic restore of the port against the reference's.

``HeartbeatMonitor`` under a simulated clock and ``plan_elastic_mesh`` over
a grid of inputs, against the reference's; then a train state checkpointed
whole by the port and restored by four gloo ranks onto a ``(2, 2)`` and a
``(4, 1)`` mesh (``CheckpointManager.restore(..., shardings=...)``, the
reference's rules through ``launch.specs.state_shardings``): each rank's
shard of every leaf against the slice the reference's
``NamedSharding.devices_indices_map`` gives on 8 forced host devices.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.runtime import fault_tolerance as jax_ft
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.runtime import HeartbeatMonitor, plan_elastic_mesh
from repro_torch.train import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"2x2": [[2, 2], ["data", "model"]], "4x1": [[4, 1], ["data", "model"]]}

_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    from jax.sharding import Mesh, NamedSharding
    from repro.configs import TrainConfig, get_config
    from repro.launch.specs import state_shardings
    from repro.parallel.sharding import make_rules
    out = {}
    for name, (shape, names) in json.loads(sys.argv[1]).items():
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), tuple(names))
        state, shard = state_shardings(get_config("tinyllama-1.1b").reduced(), TrainConfig(), mesh, make_rules(mesh))
        flat = jax.tree_util.tree_flatten_with_path(state)[0]
        shards = jax.tree.leaves(shard, is_leaf=lambda x: isinstance(x, NamedSharding))
        out[name] = {}
        for (path, leaf), s in zip(flat, shards):
            index = s.devices_indices_map(leaf.shape)
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            out[name][key] = [[[sl.start or 0, sl.stop if sl.stop is not None else n] for sl, n in zip(index[d], leaf.shape)]
                              for d in mesh.devices.reshape(-1)]
    print(json.dumps(out))
""")

_RANK = textwrap.dedent("""
    import json, sys, torch, torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.specs import state_shardings
    from repro_torch.parallel.sharding import make_rules
    rank, port, ckpt, out_dir, meshes = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], json.loads(sys.argv[5])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4, rank=rank)
    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)]
    res = {}
    for name, (shape, names) in meshes.items():
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape), mesh_dim_names=tuple(names))
        like, shardings = state_shardings(get_config("tinyllama-1.1b").reduced(), TrainConfig(), mesh, make_rules(mesh))
        state = CheckpointManager(ckpt).restore(like, shardings=shardings)
        res[name] = {k: (v.to_local(), tuple(v.placements) == tuple(s[1]), v.device_mesh is mesh)
                     for (k, v), (_, s) in zip(flat(state), flat(shardings))}
    torch.save(res, f"{out_dir}/{rank}.pt")
    dist.destroy_process_group()
""")


def test_heartbeat_monitor_matches_reference_under_a_simulated_clock():
    now = {"t": 0.0}
    clock = lambda: now["t"]  # noqa: E731
    ours, ref = HeartbeatMonitor(4, timeout=10.0, clock=clock), jax_ft.HeartbeatMonitor(4, timeout=10.0, clock=clock)
    script = [(3.0, [0, 1, 2, 3]), (9.0, [0, 2]), (14.0, [0]), (20.0, []), (20.5, [1, 3]), (31.0, [3])]
    for t, beats in script:
        now["t"] = t
        for h in beats:
            ours.beat(h)
            ref.beat(h)
        assert ours.dead_hosts() == ref.dead_hosts()
        assert ours.healthy() == ref.healthy()
        assert ours.last_seen == ref.last_seen
    assert ours.dead_hosts() == [0, 1, 2]
    assert HeartbeatMonitor(2).healthy()  # the port's wall clock by default


def test_plan_elastic_mesh_matches_reference_over_a_grid():
    for chips in (1, 7, 16, 17, 255, 256, 300, 511, 512, 513, 768, 1024, 4096):
        for mp in (1, 4, 8, 16):
            for prefer in (True, False):
                for per_pod in (128, 256):
                    args = (chips, mp, prefer, per_pod)
                    try:
                        want = jax_ft.plan_elastic_mesh(*args)
                    except ValueError as e:
                        with pytest.raises(ValueError, match=str(e)):
                            plan_elastic_mesh(*args)
                        continue
                    assert plan_elastic_mesh(*args) == want, args


@pytest.fixture(scope="module")
def restored(tmp_path_factory):
    """``(checkpointed state, reference index maps, each rank's restored shards)``."""
    base = tmp_path_factory.mktemp("elastic")
    ckpt, out_dir = str(base / "ckpt"), str(base / "out")
    os.makedirs(out_dir)
    state = init_train_state(get_config("tinyllama-1.1b").reduced(), TrainConfig(), seed=3, device="cpu")
    state["step"].fill_(5)
    CheckpointManager(ckpt).save(5, state)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    meshes = json.dumps(MESHES)
    procs = [subprocess.Popen([sys.executable, "-c", _JAX_SIDE, meshes], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, ckpt, out_dir, meshes], env=env, cwd=ROOT,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(4)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(out)
    index = json.loads(outs[0].strip().splitlines()[-1])
    return state, index, [torch.load(f"{out_dir}/{r}.pt") for r in range(4)]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        yield from _flat(v, prefix + k + "/") if isinstance(v, dict) else [(prefix + k, v)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_restore_onto_a_new_mesh_gives_each_rank_the_reference_shard(restored, mesh):
    state, index, ranks = restored
    whole = dict(_flat(state))
    assert set(index[mesh]) == set(whole)
    sharded = 0
    for key, full in whole.items():
        for rank in range(4):
            local, same_placements, same_mesh = ranks[rank][mesh][key]
            assert same_placements and same_mesh
            want = full[tuple(slice(a, b) for a, b in index[mesh][key][rank])]
            assert local.dtype == full.dtype
            torch.testing.assert_close(local, want, rtol=0, atol=0)
        sharded += any(tuple(local.shape) != tuple(full.shape) for local in (ranks[0][mesh][key][0],))
    assert sharded > 0  # the rules shard the matrices
