"""Context-parallel decode attention of the port against the reference's.

Four gloo ranks (processes of their own) each hold one contiguous shard of
the cache's sequence and call ``context_parallel_decode_attention``; the
reference's body runs on the same shards under
``jax.jit(jax.vmap(partial(body, axis_name="x"), axis_name="x"))`` on the
one CPU device (ROADMAP R9).  Each rank's partials and output are held
against the reference's and against dense attention over the whole cache,
in float32 and in bfloat16; a group of one rank combines to its own
partials' softmax.
"""

import functools
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.context_parallel import context_parallel_decode_attention as jax_cp
from repro.serving.context_parallel import local_partial_attention as jax_partials
from repro_torch.serving.context_parallel import local_partial_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P, B, S, K, G, HD = 4, 2, 64, 2, 3, 16
VALID = 41  # positions 0 ... 40 hold keys: rank 3's shard is all invalid, rank 2's in part
F32_TOL = dict(rtol=2e-6, atol=2e-6)  # the reference's einsums and collectives sum in another order
DENSE_TOL = dict(rtol=2e-5, atol=2e-5)  # as tests/test_context_parallel.py holds the reference
BF16_TOL = dict(rtol=2e-2, atol=2e-2)  # p rounded to bfloat16 before the value product, in both

_RANK = textwrap.dedent("""
    import sys, torch, torch.distributed as dist
    from repro_torch.serving.context_parallel import combine_partials, context_parallel_decode_attention, local_partial_attention
    rank, world, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world, rank=rank)
    alone = [dist.new_group([r]) for r in range(world)]
    inputs = torch.load(path + "/inputs.pt")
    out = {}
    for name, (q, k, v, valid) in inputs.items():
        n = k.shape[1] // world
        ks, vs, va = (t[:, rank * n:(rank + 1) * n] for t in (k, v, valid))
        out[name] = {"partials": local_partial_attention(q, ks, vs, va),
                     "out": context_parallel_decode_attention(q, ks, vs, va),
                     "alone": combine_partials(*local_partial_attention(q, ks, vs, va), group=alone[rank])}
    torch.save(out, f"{path}/out.{rank}.pt")
    dist.destroy_process_group()
""")


def _inputs(dtype):
    rng = np.random.default_rng(0 if dtype == np.float32 else 1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in ((B, K, G, HD), (B, S, K, HD), (B, S, K, HD)))
    valid = np.repeat((np.arange(S) < VALID)[None], B, 0)
    return q, k, v, valid


def _torch(arrays, dtype):
    return tuple(torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a) for a in arrays)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's outputs, for both dtypes."""
    import socket

    path = str(tmp_path_factory.mktemp("cp"))
    torch.save({"f32": _torch(_inputs(np.float32), torch.float32), "bf16": _torch(_inputs(np.float32), torch.bfloat16)},
               path + "/inputs.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(P), port, path], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(P)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    return [torch.load(f"{path}/out.{r}.pt") for r in range(P)]


def _reference(q, k, v, valid, dtype):
    """The reference's body on the stacked shards, one per vmapped rank."""
    n = S // P
    shard = lambda t: jnp.stack([jnp.asarray(t)[:, r * n:(r + 1) * n] for r in range(P)])
    qs = jnp.broadcast_to(jnp.asarray(q, dtype), (P,) + q.shape)
    ks, vs, va = shard(k.astype(dtype) if dtype != np.float32 else k), shard(v), shard(valid)
    ks, vs = ks.astype(dtype), vs.astype(dtype)
    body = jax.jit(jax.vmap(functools.partial(jax_cp, axis_name="x"), axis_name="x"))
    partials = jax.jit(jax.vmap(jax_partials))(qs, ks, vs, va)
    return [np.asarray(x) for x in partials], np.asarray(body(qs, ks, vs, va))


def _dense(q, k, v, valid):
    s = np.einsum("bkgh,bskh->bkgs", q, k) / math.sqrt(HD)
    s = np.where(valid[:, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bkgs,bskh->bkgh", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("name,dtype,tol", [("f32", jnp.float32, F32_TOL), ("bf16", jnp.bfloat16, BF16_TOL)])
def test_ranks_match_the_reference_body_and_dense_attention(ranks, name, dtype, tol):
    q, k, v, valid = _inputs(np.float32)
    (m, l, o), want = _reference(q, k, v, valid, dtype)
    for r, got in enumerate(ranks):
        gm, gl, go = (t.numpy() for t in got[name]["partials"])
        if r == P - 1:  # no valid key: the max is the mask value, every weight exp(0)
            assert np.all(gm == np.float32(-1e30)) and np.all(m[r] == np.float32(-1e30))
        np.testing.assert_allclose(gm, m[r], **tol)
        np.testing.assert_allclose(gl, l[r], **tol)
        np.testing.assert_allclose(go, o[r], **tol)
        np.testing.assert_allclose(got[name]["out"].numpy(), want[r], **tol)
        assert got[name]["out"].dtype == torch.float32
        np.testing.assert_array_equal(got[name]["out"].numpy(), ranks[0][name]["out"].numpy())  # one answer
    dense_tol = DENSE_TOL if name == "f32" else BF16_TOL
    np.testing.assert_allclose(ranks[0][name]["out"].numpy(), _dense(q, k, v, valid), **dense_tol)


def test_a_group_of_one_rank_is_its_own_softmax(ranks):
    q, k, v, valid = _torch(_inputs(np.float32), torch.float32)
    n = S // P
    for r in range(P - 1):  # the last rank's shard has no valid key
        sl = slice(r * n, (r + 1) * n)
        want = _dense(*(t.numpy() for t in (q, k[:, sl], v[:, sl], valid[:, sl])))
        np.testing.assert_allclose(ranks[r]["f32"]["alone"].numpy(), want, **DENSE_TOL)
        m, l, o = local_partial_attention(q, k[:, sl], v[:, sl], valid[:, sl])
        np.testing.assert_array_equal(ranks[r]["f32"]["partials"][2].numpy(), o.numpy())
