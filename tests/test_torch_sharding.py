"""The port's sharding rules, shardings, roofline and dry run against the reference's.

* ``param_spec``/``param_pspec_tree`` against the reference's
  ``tuple(PartitionSpec)`` on every leaf of every reduced architecture,
  under the single-pod and the multi-pod rules;
* ``make_rules`` and ``sanitize_spec`` on the reference's own cases;
* each rank's local shard of a DTensor on fake ``(2, 2)``, ``(1, 2, 2)``
  and ``(2, 2, 1)`` meshes against the slice the reference's
  ``NamedSharding.devices_indices_map`` gives on 8 forced host devices;
* ``state_shardings``' bytes on rank 0 against the sum of the reference's
  ``shard_shape`` bytes, at full width;
* ``model_flops`` and the ``Roofline`` terms on the H100's constants;
* the dry run of reduced tinyllama (train, prefill and decode, whose
  token is written into each device's shard of the context-sharded cache)
  and of reduced moonshot (train and prefill: the MoE dispatch's
  ``searchsorted`` and scatters on DTensors) on a fake ``(2, 2)`` mesh;
* ``write_token_sharded`` on every rank's shard against the global write,
  and a plain-tensor ``decode_attention`` writing its cache in place.

The fake groups and the forced device count each run in a process of their
own (a process holds one default group, and jax fixes its device count at
its first use); both start together.
"""

import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import roofline as jax_rl
from repro.models import abstract_params as jax_abstract_params
from repro.parallel import sharding as jax_sh
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.launch import roofline as rl
from repro_torch.models import abstract_params
from repro_torch.parallel import sharding as sh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = {"2x2": ((2, 2), ("data", "model")), "1x2x2": ((1, 2, 2), ("pod", "data", "model")),
          "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
# (mesh, global shape, spec): every entry form, sharded dims with leading and trailing replicated ones
CASES = [
    ("2x2", (8, 12), ("data", "model")),
    ("2x2", (8, 12), ("model", "data")),
    ("2x2", (6, 8, 4), (None, "model", None)),
    ("2x2", (8, 6), (("data", "model"), None)),
    ("1x2x2", (8, 12), (("pod", "data"), "model")),
    ("1x2x2", (4, 8, 6), (None, "model", "data")),
    ("2x2x1", (8, 12), (("pod", "data"), None)),
    ("2x2x1", (6, 8), ("data", "pod")),
    ("2x2x1", (4, 8, 2), ("pod", ("data", "model"), None)),
]
STATE_CELLS = [("tinyllama-1.1b", "2x2", False), ("nemotron-4-340b", "2x2x1", True), ("tinyllama-1.1b", "1x2x2", False)]

_JAX_SIDE = textwrap.dedent("""
    import json, sys
    import numpy as np, jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.configs import TrainConfig, get_config
    from repro.launch.specs import state_shardings
    from repro.parallel.sharding import make_rules
    meshes, cases, cells = json.loads(sys.argv[1])
    def mesh(name):
        shape, names = meshes[name]
        return Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape), tuple(names))
    def entry(e):
        return tuple(e) if isinstance(e, list) else e
    out = {"index": [], "state": []}
    for name, shape, spec in cases:
        m = mesh(name)
        index = NamedSharding(m, P(*map(entry, spec))).devices_indices_map(tuple(shape))
        out["index"].append([[[s.start or 0, s.stop if s.stop is not None else n] for s, n in zip(index[d], shape)]
                             for d in m.devices.reshape(-1)])
    for arch, name, over_pod in cells:
        m = mesh(name)
        cfg = get_config(arch)
        state, shard = state_shardings(cfg, TrainConfig(), m, make_rules(m, fsdp_over_pod=over_pod))
        leaves = jax.tree.leaves(state)
        shards = jax.tree.leaves(shard, is_leaf=lambda x: isinstance(x, NamedSharding))
        out["state"].append(sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize for l, s in zip(leaves, shards)))
    print(json.dumps(out))
""")

_PORT_SIDE = textwrap.dedent("""
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.specs import state_shardings
    from repro_torch.parallel.sharding import make_rules, placements, put_tree, write_token_sharded
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    meshes, cases, cells = json.loads(sys.argv[1])
    def mesh(name):
        shape, names = meshes[name]
        return DeviceMesh("cpu", torch.arange(4).reshape(shape), mesh_dim_names=tuple(names))
    def entry(e):
        return tuple(e) if isinstance(e, list) else e
    out = {"local": [[] for _ in cases], "state": [], "dryrun": {}, "write": []}
    for rank in range(4):
        dist.init_process_group("fake", rank=rank, world_size=4, store=FakeStore())
        for i, (name, shape, spec) in enumerate(cases):
            m = mesh(name)
            x = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
            local = distribute_tensor(x, m, placements(tuple(map(entry, spec)), m), src_data_rank=None).to_local()
            out["local"][i].append(local.tolist())
        # the decode write into this rank's shard of a (B, S, K, hd) cache sharded on batch and kv-seq
        m = mesh("2x2")
        full = torch.arange(4 * 8 * 2 * 3, dtype=torch.float32).reshape(4, 8, 2, 3)
        cache = distribute_tensor(full.clone(), m, [Shard(0), Shard(1)], src_data_rank=None)
        slot, new = torch.tensor([0, 5, 3, 7]), -1.0 - torch.arange(4 * 2 * 3, dtype=torch.float32).reshape(4, 2, 3)
        write_token_sharded(cache, slot, new)
        want = full.clone()
        want[torch.arange(4), slot] = new
        shape, offset = compute_local_shape_and_global_offset(cache.shape, m, cache.placements)
        region = want[offset[0]: offset[0] + shape[0], offset[1]: offset[1] + shape[1]]
        # the dry run's counter sees the write on the local shard: it reads and writes the shard at least once
        counter = dryrun.StepCounter()
        outer, inner = counter.modes()
        with outer, inner:
            write_token_sharded(cache, slot, new)
        local_bytes = cache.to_local().numel() * cache.to_local().element_size()
        out["write"].append(bool(torch.equal(cache.to_local(), region)) and counter.bytes >= 2 * local_bytes)
        if rank == 0:
            for arch, name, over_pod in cells:
                m = mesh(name)
                state, shard = state_shardings(get_config(arch), TrainConfig(), m, make_rules(m, fsdp_over_pod=over_pod))
                out["state"].append(dryrun.tree_bytes(put_tree(state, shard)))
            # chunks of 4096 keys past the dense threshold: the reduced config's 32 would loop 1024 times a layer
            cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(), attn_chunk=4096)
            moe = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), attn_chunk=4096)
            cells = [(cfg, s) for s in ("train_4k", "prefill_32k", "decode_32k")]
            cells += [(moe, s) for s in ("train_4k", "prefill_32k")]
            for c, shape in cells:
                try:
                    rec = dryrun.lower_cell(c.name, shape, False, cfg_override=c, mesh=make_debug_mesh(2, 2))
                except Exception as e:
                    rec = dryrun.error_record(c.name, shape, False, e)
                key = shape if c is cfg else f"moe/{shape}"
                out["dryrun"][key] = {k: rec.get(k) for k in ("status", "op", "error", "chips", "memory_analysis",
                                                               "roofline")}
        dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def sides():
    """Both processes, started together: ``(reference, port)`` outputs."""
    arg = json.dumps([MESHES, CASES, STATE_CELLS])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    procs = [subprocess.Popen([sys.executable, "-c", code, arg], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for code in (_JAX_SIDE, _PORT_SIDE)]
    outs = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        outs.append(json.loads(stdout.strip().splitlines()[-1]))
    return outs


def _canon(spec):
    """A reference ``PartitionSpec`` as the port writes specs."""
    out = []
    for e in tuple(spec):
        if isinstance(e, tuple):
            e = None if not e else (e[0] if len(e) == 1 else e)
        out.append(e)
    return tuple(out)


def _leaves_with_path(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves_with_path(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference_on_every_leaf(arch):
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    params, jparams = abstract_params(cfg), jax_abstract_params(jcfg)
    for over_pod in (False, True):
        rules = sh.MeshRules(batch=("pod", "data"), fsdp=("pod", "data") if over_pod else ("data",))
        jrules = jax_sh.MeshRules(batch=("pod", "data"), fsdp=("pod", "data") if over_pod else ("data",))
        ours = dict(_leaves_with_path(sh.param_pspec_tree(params, rules)))
        theirs = {tuple(getattr(k, "key", k) for k in path): _canon(spec) for path, spec in
                  jax.tree_util.tree_flatten_with_path(jax_sh.param_pspec_tree(jparams, jrules),
                                                       is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        assert ours == theirs
        for path, leaf in _leaves_with_path(params):
            assert len(ours[path]) == leaf.ndim and sh.param_spec(path, leaf)[1] == path[-1]


def _mesh_stub(shape, names):
    return SimpleNamespace(shape=tuple(shape), mesh_dim_names=tuple(names))


def test_make_rules_and_sanitize_spec_on_the_reference_cases():
    mesh = _mesh_stub((1, 2, 2), ("pod", "data", "model"))
    r1 = sh.make_rules(mesh)
    assert r1.batch == ("pod", "data") and r1.fsdp == ("data",)
    assert sh.make_rules(mesh, fsdp_over_pod=True).fsdp == ("pod", "data")
    assert sh.make_rules(mesh, context_parallel=True).context == ("model",)
    assert sh.make_rules(_mesh_stub((2, 2), ("data", "model")), fsdp_over_pod=True).fsdp == ("data",)
    mesh = _mesh_stub((1, 4), ("data", "model"))
    assert sh.sanitize_spec(("model", "data"), (32001, 1600), mesh) == (None, "data")
    assert sh.sanitize_spec(("model", "data"), (32000, 1600), mesh) == ("model", "data")
    assert sh.sanitize_spec((("data", "model"),), (6,), mesh) == (None,)
    assert sh.MeshRules(context=("model",)).spec("batch", None, "context", "tensor") == ("data", None, "model", "model")
    assert sh.MeshRules(batch=("pod", "data")).spec("batch") == (("pod", "data"),)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_local_shards_match_the_reference_index_map(sides, case):
    ref, port = sides
    name, shape, _ = CASES[case]
    x = np.arange(int(np.prod(shape))).reshape(shape)
    for rank, index in enumerate(ref["index"][case]):
        want = x[tuple(slice(a, b) for a, b in index)]
        np.testing.assert_array_equal(np.array(port["local"][case][rank]).reshape(want.shape), want)


def test_state_shardings_bytes_match_the_reference_shard_shapes(sides):
    ref, port = sides
    assert port["state"] == ref["state"]


def _assert_ok_cell(rec, wire: bool = True):
    assert rec["status"] == "ok" and rec["chips"] == 4, rec
    roof, mem = rec["roofline"], rec["memory_analysis"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["wire_bytes_per_device"] > 0 or not wire
    assert mem["argument_bytes"] > 0 and mem["output_bytes"] > 0 and mem["temp_bytes"] > 0
    # every device does at least its share of the model's flops
    assert roof["flops_per_device"] * 4 >= roof["model_flops"]


def test_dry_run_of_reduced_tinyllama_on_a_fake_mesh(sides):
    _, port = sides
    cells = port["dryrun"]
    for shape in ("train_4k", "prefill_32k"):
        _assert_ok_cell(cells[shape])
    # decode writes its token into each device's shard of the context-sharded cache, in place
    _assert_ok_cell(cells["decode_32k"], wire=False)


def test_dry_run_of_reduced_moe_on_a_fake_mesh(sides):
    """The MoE dispatch on DTensors: the routing's insertion points
    (``aten.searchsorted.Tensor``, given a rule), the merges' scatters
    into fresh buffers, and the experts' products on shards that a
    redistribution left strided, forward and backward."""
    _, port = sides
    for shape in ("train_4k", "prefill_32k"):
        _assert_ok_cell(port["dryrun"][f"moe/{shape}"])


def test_sharded_token_write_matches_the_global_write_on_every_rank(sides):
    _, port = sides
    assert port["write"] == [True] * 4


def test_plain_decode_writes_the_cache_in_place():
    from repro_torch.models.attention import decode_attention

    gen = torch.Generator().manual_seed(0)
    b, s, kv, hd, heads, d = 3, 8, 2, 4, 4, 16
    params = {w: torch.randn(shape, generator=gen) for w, shape in
              (("wq", (d, heads * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)), ("wo", (heads * hd, d)))}
    cache_k, cache_v = torch.zeros((b, s, kv, hd)), torch.zeros((b, s, kv, hd))
    ptrs = (cache_k.data_ptr(), cache_v.data_ptr())
    x, pos = torch.randn((b, 1, d), generator=gen), torch.tensor([0, 5, 11])
    _, ck, cv = decode_attention(params, x, cache_k, cache_v, pos, num_heads=heads, num_kv=kv, head_dim=hd,
                                 rope_theta=0.0)
    assert (ck.data_ptr(), cv.data_ptr()) == ptrs and ck is cache_k and cv is cache_v
    slots = torch.tensor([0, 5, 7])  # clamped to the last slot
    want_k = (x[:, 0] @ params["wk"]).reshape(b, kv, hd)
    assert torch.equal(cache_k[torch.arange(b), slots], want_k)
    assert int((cache_k.abs().sum((2, 3)) > 0).sum()) == b  # nothing else written


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.n_params() == jcfg.n_params() and cfg.n_active_params() == jcfg.n_active_params()
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        assert rl.model_flops(cfg, shape) == jax_rl.model_flops(jcfg, jshape)


def test_roofline_terms_on_h100_constants():
    r = rl.Roofline(flops_per_device=989e12, bytes_per_device=3.35e12 / 2, wire_bytes_per_device=450e9 * 2,
                    collective_detail={}, chips=256, model_flops=989e12 * 256 * 0.5)
    assert r.bottleneck == "collective"
    assert abs(r.t_compute - 1.0) < 1e-12 and abs(r.t_memory - 0.5) < 1e-12 and abs(r.t_step - 2.0) < 1e-12
    assert abs(r.mfu_bound - 0.25) < 1e-12 and abs(r.useful_flops_fraction - 0.5) < 1e-12
    d = r.to_dict()
    assert set(d) == set(jax_rl.Roofline(1, 1, 1, {}, 1, 1).to_dict())
    c = rl.collective_bytes([("all-reduce", 100), ("all-gather", 10), ("all-reduce", 1), ("all-to-all", 7)])
    assert c["all-reduce"] == 202 and c["all-gather"] == 10 and c["all-to-all"] == 7
    assert c["counts"] == {"all-reduce": 2, "all-gather": 1, "reduce-scatter": 0, "all-to-all": 1,
                           "collective-permute": 0}


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.phase_parallel`` at a tiny size on the CPU (no dry-run
    cell: the test above runs one): every check of phase 14 runs on the
    plain versions, and nothing is launched."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(ROOT) / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    reset_launches()
    out = chip.phase_parallel(device="cpu", reduce=True, prompt=40, new_tokens=3, step_prompt=8, comp_seq=24, steps=1,
                              cp_len=4000, cp_shards=8, dry=None)
    assert out["nemotron"]["k4_launches"] == out["nemotron"]["s1_launches"] == 0
    assert out["nemotron"]["row"]["max_abs_err"] == 0
    assert out["compression"]["topk"]["small_leaves"] == out["compression"]["topk"]["leaves"] == 11
    for dtype in ("bfloat16", "float32"):
        rec = out["context_parallel"][dtype]
        assert max(rec["max_abs_err"].values()) <= rec["rtol_of_max"] * rec["max_abs_out"]
    assert all(fn.launches == 0 for fn in WRAPPERS)
