"""The port's distributed merges, partition math, top-k and sampler route against the reference.

The port side runs on four gloo ranks spawned once for the module
(``chip_smoke.start_dist_cases``: CPU tensors, so the kernels' plain
versions), each case on its ceil-div shards, the ``P = 3`` cases on a
group of ranks 0-2.  The reference side runs the JAX package's per-device
bodies (``_merge_local_body``, ``_topk_local_body`` and the ``_local``
forms) under ``jax.jit(jax.vmap(partial(body, axis_name="x"),
axis_name="x"))`` on this process's one CPU device, where the named axis
carries ``psum``, ``all_gather``, ``all_to_all`` and ``ppermute``; no fake
device count is set.  The ranks, and phase 11 of ``chip_smoke.py`` on the
CPU in a subprocess of its own, run while the reference compiles.  Every
segment, value and index is compared bit for bit.
"""

import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.telemetry import spans as ref_spans
from repro_torch.core import distributed as D
from repro_torch.telemetry import spans as port_spans

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the spawned ranks import chip_smoke by name
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

WORLD = 4
MERGE_SHAPES = ((512, 512), (513, 511), (700, 37), (5, 1000))
I32_MAX, I32_MIN = np.iinfo(np.int32).max, np.iinfo(np.int32).min
PHASE = ("import chip_smoke; chip_smoke.phase_distributed(device='cpu', log2n=10, topk_shape=(2, 300), "
         "gloo_log2n=9, stage_ranks=2, stage_log2n=11)")


def _sorted(rng, shape, dtype, lo=None, hi=None):
    if lo is None:
        return np.sort(rng.standard_normal(shape).astype(dtype), axis=-1)
    return np.sort(rng.integers(lo, hi, shape).astype(dtype), axis=-1)


def _stack(x, p, fill):
    """``(..., n)`` as ``(p, ..., m)`` shards, padded with ``fill``: the
    reference's ``_pad_shardable`` and ``shard_map`` split."""
    n = x.shape[-1]
    m = -(-n // p)
    xp = np.concatenate([x, np.full(x.shape[:-1] + (m * p - n,), fill, x.dtype)], axis=-1)
    return np.moveaxis(xp.reshape(x.shape[:-1] + (p, m)), -2, 0)


def _sentinel(dtype):
    return np.inf if np.issubdtype(dtype, np.floating) else np.iinfo(dtype).max


@functools.lru_cache(maxsize=None)
def _vmapped(body, **kw):
    """The reference body over a named axis on one device, jitted.  The
    bodies compare, gather and scatter, so LLVM's optimisation level
    changes no bit; level 0 only shortens the compiles."""
    return jax.jit(jax.vmap(functools.partial(body, axis_name="x", **kw), axis_name="x"),
                   compiler_options={"xla_backend_optimization_level": 0})


def _ref_merge_body(a, av, b, bv, *, axis_name, na, nb, p, exchange, kv):
    keys, vals = RD._merge_local_body(a, av if kv else None, b, bv if kv else None, axis_name=axis_name,
                                      na=na, nb=nb, p=p, exchange=exchange)
    return keys, (vals if kv else keys)


def _ref_merge(ak, av, bk, bv, p, exchange):
    """The reference body's ``(P, R, seg)`` segments (keys, values or None)."""
    kv = av is not None
    fill = _sentinel(ak.dtype)
    args = [_stack(ak, p, fill), _stack(av if kv else ak, p, 0), _stack(bk, p, fill), _stack(bv if kv else bk, p, 0)]
    fn = _vmapped(_ref_merge_body, na=ak.shape[-1], nb=bk.shape[-1], p=p, exchange=exchange, kv=kv)
    keys, vals = fn(*args)
    return np.asarray(keys), (np.asarray(vals) if kv else None)


def _topk_rows(rng):
    """Float rows (vocab 192) and int rows (64) for the top-k.  Top-k is row
    by row, so the reference body runs once per exchange on each stack and
    the 1-D cases read their row of it."""
    rows = (rng.standard_normal((5, 192)) * 3).astype(np.float32)
    rows[1] = -np.inf  # a row full of -inf: no pad index may surface
    rows[1, 10], rows[1, 150] = 1.0, 2.0
    irows = rng.integers(-50, 50, (2, 64)).astype(np.int32)
    irows[0] = I32_MIN  # int shards at iinfo.min: flip_desc must not wrap them
    irows[0, 10], irows[0, 40] = 5, -3
    return rows, irows


def _build(rng):
    """Every case: the port's case for the ranks and the reference's answer
    as ``(P, ...)`` per rank (None where the port is held against itself)."""
    cases, refs, memo = [], {}, {}

    def ref(f, *args):  # one reference run per body and inputs, shared by the cases that read it
        key = (f.__name__,) + tuple(id(a) if isinstance(a, np.ndarray) else a for a in args)
        if key not in memo:
            memo[key] = f(*args)
        return memo[key]

    def add(name, fn, p, args, shard, want, **kwargs):
        cases.append({"name": name, "fn": fn, "p": p, "args": [torch.from_numpy(np.ascontiguousarray(a))
                                                               if isinstance(a, np.ndarray) else a for a in args],
                      "shard": list(shard), "kwargs": kwargs})
        refs[name] = want

    for na, nb in MERGE_SHAPES:
        a, b = _sorted(rng, na, np.float32), _sorted(rng, nb, np.float32)
        for p, ex in ((WORLD, "window"), (WORLD, "gather"), (3, "gather")):
            if p == 3 and (na, nb) != (700, 37):
                continue
            add(f"merge_{na}_{nb}_p{p}_{ex}", "distributed_merge", p, (a, b), (1, 1),
                lambda a=a, b=b, p=p, ex=ex: _ref_merge(a[None], None, b[None], None, p, ex), exchange=ex)
    # int32 keys with iinfo.max payloads and int32 values, R = 3 (row 0 for the 1-D form);
    # int16 keys through the byte view, R = 3
    ka, kb = _sorted(rng, (3, 301), np.int32, -40, 40), _sorted(rng, (3, 203), np.int32, -40, 40)
    ka[:, -30:], kb[:, -11:] = I32_MAX, I32_MAX
    kav = rng.integers(0, 1 << 20, (3, 301)).astype(np.int32)
    kbv = rng.integers(-(1 << 20), 0, (3, 203)).astype(np.int32)
    ra, rb = _sorted(rng, (3, 150), np.int16, -300, 300), _sorted(rng, (3, 97), np.int16, -300, 300)
    ra[:, -5:] = np.iinfo(np.int16).max
    for ex in ("window", "gather"):
        kv_ref = functools.partial(ref, _ref_merge, ka, kav, kb, kbv, WORLD, ex)
        add(f"merge_kv_imax_{ex}", "distributed_merge_kv", WORLD, (ka[0], kav[0], kb[0], kbv[0]), (1, 1, 1, 1),
            lambda kv_ref=kv_ref: tuple(x[:, :1] for x in kv_ref()), exchange=ex)
        add(f"merge_kv_batched_{ex}", "distributed_merge_kv_batched", WORLD, (ka, kav, kb, kbv), (1, 1, 1, 1),
            kv_ref, exchange=ex)
        add(f"merge_batched_int16_{ex}", "distributed_merge_batched", WORLD, (ra, rb), (1, 1),
            lambda ex=ex: _ref_merge(ra, None, rb, None, WORLD, ex), exchange=ex)
    la, lb = _sorted(rng, 96, np.float32), _sorted(rng, 64, np.float32)

    def ref_local():
        fn = _vmapped(RD.distributed_merge_local)
        return np.asarray(fn(jnp.asarray(la.reshape(WORLD, -1)), jnp.asarray(lb.reshape(WORLD, -1))))[:, None, :], None

    add("merge_local", "distributed_merge_local", WORLD, (la, lb), (1, 1), ref_local)

    rows, irows = _topk_rows(rng)
    for p, ex in ((WORLD, "butterfly"), (WORLD, "gather"), (WORLD, "auto"), (3, "gather"), (3, "auto")):
        body_ex = "gather" if ex == "gather" or p == 3 else "butterfly"
        want = functools.partial(ref, _ref_topk, rows, 16, p, body_ex)
        add(f"topk_batched_p{p}_{ex}", "distributed_topk_batched", p, (rows[2:], 16), (1, 0),
            lambda want=want: tuple(x[:, 2:] for x in want()), exchange=ex)
        if ex != "auto":
            for r, kind in ((0, "normal"), (1, "ninf")):
                add(f"topk_{kind}_p{p}_{ex}", "distributed_topk", p, (rows[r], 16), (1, 0),
                    lambda want=want, r=r: tuple(x[:, r] for x in want()), exchange=ex)
        if p == WORLD and ex == "butterfly":
            iwant = functools.partial(ref, _ref_topk, irows, 4, p, body_ex)
            add(f"topk_imin_p{p}_{ex}", "distributed_topk", p, (irows[0], 4), (1, 0),
                lambda iwant=iwant: tuple(x[:, 0] for x in iwant()), exchange=ex)
    add("topk_local", "distributed_topk_local", WORLD, (rows[0],), (1,),
        lambda: tuple(x[:, 0] for x in ref(_ref_topk, rows, 16, WORLD, "gather")), k=16)
    add("topk_butterfly_p3", "distributed_topk_batched", 3, (rows, 16), (1, 0), None, exchange="butterfly")
    # the sampler's distributed route against its kernel route, one seed on every rank
    vocab = (rng.standard_normal((4, 1000)) * 3).astype(np.float32)
    add("sample", "sample", WORLD, (vocab,), (1,), None, k=40, seed=5)
    add("dsort_main", "dsort", WORLD, (), (), None, argv=["--device", "cpu", "--log2n", "10"])
    return cases, refs


def _ref_topk(x, k, p, exchange):
    fn = _vmapped(RD._topk_local_body, k=k, p=p, exchange=exchange, batched=True)
    v, i = fn(jnp.asarray(_stack(x, p, 0)))
    return np.asarray(v), np.asarray(i)


@pytest.fixture(scope="module")
def runs():
    # one thread a process: the phase's ranks and this module's run beside the reference's compiles
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]), OMP_NUM_THREADS="1")
    phase = subprocess.Popen([sys.executable, "-c", PHASE], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        cases, refs = _build(np.random.default_rng(25))
        with tempfile.TemporaryDirectory() as tmp:
            ctx, out_dir = chip_smoke.start_dist_cases(cases, WORLD, tmp)
            want = {name: (ref() if ref is not None else None) for name, ref in refs.items()}
            got = chip_smoke.dist_case_results(ctx, out_dir, cases, timeout=300)
        phase_out, _ = phase.communicate(timeout=300)
    finally:
        if phase.poll() is None:
            phase.kill()
            phase.communicate()
    out = {c["name"]: (c, got[c["name"]], want[c["name"]]) for c in cases}
    out["phase"] = (phase.returncode, phase_out)
    return out


def test_phase_distributed_runs_on_the_cpu(runs):
    rc, out = runs["phase"]
    assert rc == 0, out[-4000:]
    assert "distributed: (a) one rank (gloo, world size 1)" in out
    assert "distributed: (b) gloo, 4 spawned ranks" in out
    assert "emulated exchange (one card" in out


def _np(t):
    return t.numpy()


MERGE_CASES = [f"merge_{na}_{nb}_p{p}_{ex}" for na, nb in MERGE_SHAPES
               for p, ex in ((WORLD, "window"), (WORLD, "gather"), (3, "gather"))
               if p == WORLD or (na, nb) == (700, 37)]
MERGE_CASES += [f"{what}_{ex}" for what in ("merge_kv_imax", "merge_kv_batched", "merge_batched_int16")
                for ex in ("window", "gather")] + ["merge_local"]


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_segments_match_the_reference_body(runs, name):
    case, outs, (ref_keys, ref_vals) = runs[name]
    for r, res in enumerate(outs):
        assert "error" not in res, res.get("error")
        out = res["out"]
        keys, vals = out if isinstance(out, tuple) else (out, None)
        keys = keys if keys.ndim == 2 else keys[None]
        n = keys.shape[-1]
        np.testing.assert_array_equal(_np(keys), ref_keys[r, :, :n])
        if ref_vals is not None:
            vals = vals if vals.ndim == 2 else vals[None]
            np.testing.assert_array_equal(_np(vals), ref_vals[r, :, :n])
    # the segments are the ceil-div partition of the whole merge
    keys_in = case["args"][::2] if name.startswith("merge_kv") else case["args"]
    n_all = sum(_np(res["out"][0] if isinstance(res["out"], tuple) else res["out"]).shape[-1] for res in outs)
    assert n_all == sum(a.shape[-1] for a in keys_in)


@pytest.mark.parametrize("pair", [("merge_513_511_p4_window", "merge_513_511_p4_gather"),
                                  ("merge_5_1000_p4_window", "merge_5_1000_p4_gather"),
                                  ("merge_kv_batched_window", "merge_kv_batched_gather")])
def test_window_and_gather_exchanges_agree(runs, pair):
    for rw, rg in zip(runs[pair[0]][1], runs[pair[1]][1]):
        w, g = rw["out"], rg["out"]
        for x, y in zip(w if isinstance(w, tuple) else (w,), g if isinstance(g, tuple) else (g,)):
            assert torch.equal(x, y)


TOPK_CASES = [f"topk_{kind}_p{p}_{ex}" for p in (WORLD, 3) for ex in ("butterfly", "gather")
              for kind in ("normal", "ninf") if not (p == 3 and ex == "butterfly")]
TOPK_CASES += [f"topk_imin_p{WORLD}_butterfly", "topk_local"]
TOPK_CASES += [f"topk_batched_p{p}_{ex}" for p, ex in
               ((WORLD, "butterfly"), (WORLD, "gather"), (WORLD, "auto"), (3, "gather"), (3, "auto"))]


@pytest.mark.parametrize("name", TOPK_CASES)
def test_topk_matches_the_reference_body_on_every_rank(runs, name):
    _, outs, (ref_v, ref_i) = runs[name]
    for r, res in enumerate(outs):
        assert "error" not in res, res.get("error")
        v, i = res["out"]
        np.testing.assert_array_equal(_np(v), ref_v[r])
        np.testing.assert_array_equal(_np(i), ref_i[r])
        assert (_np(i) >= 0).all()


def test_butterfly_raises_at_three_ranks(runs):
    _, outs, _ = runs["topk_butterfly_p3"]
    assert all("power-of-two" in res.get("error", "") for res in outs)
    with pytest.raises(ValueError, match="power-of-two"):
        RD._resolve_topk_exchange("butterfly", 3)


def test_distributed_sampler_draws_the_kernel_routes_token(runs):
    _, outs, _ = runs["sample"]
    first = outs[0]["out"][0]
    for res in outs:
        dist_tok, kernel_tok = res["out"]
        assert torch.equal(dist_tok, kernel_tok) and torch.equal(dist_tok, first)


def test_distributed_sampler_refuses_vocab_lens():
    from repro_torch.serving import topk_sample

    with pytest.raises(ValueError, match="vocab_lens is not supported"):
        topk_sample(torch.zeros(1, 8), torch.Generator(), k=2, vocab_lens=4, backend="distributed")


def test_dsort_launcher_runs_on_cpu_ranks(runs):
    _, outs, _ = runs["dsort_main"]
    for res in outs:
        rep = res["out"]
        assert rep["merge_ok"] and rep["sort_ok"] and rep["topk_ok"] and not rep["overflow"]
        assert rep["ranks"] == WORLD and sum(rep["counts"]) == 2 << 10


def test_dsort_launcher_needs_a_card_unless_told_cpu():
    from repro_torch.launch import dsort

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dsort.main([])


GRID = [(0, 0, 1), (0, 9, 4), (7, 0, 3), (1, 1, 8), (5, 1000, 4), (513, 511, 4), (700, 37, 3), (1, 100, 7),
        (1024, 1024, 8), (999, 1, 2), (37, 700, 5)]


@pytest.mark.parametrize("na,nb,p", GRID)
def test_partition_math_matches_the_reference(na, nb, p):
    assert D.window_bounds(na, nb, p) == RD.window_bounds(na, nb, p)
    for itemsize, kv, rows in ((4, False, 1), (2, True, 3)):
        assert D.exchange_bytes(na, nb, p, itemsize, kv, rows) == RD.exchange_bytes(na, nb, p, itemsize, kv, rows)


def test_window_bounds_rejects_no_ranks():
    with pytest.raises(ValueError):
        D.window_bounds(4, 4, 0)


@pytest.mark.parametrize("na,nb,p,rows", [(700, 37, 3, 2)])
def test_merge_telemetry_matches_the_reference(na, nb, p, rows):
    rng = np.random.default_rng(na)
    a, b = _sorted(rng, (rows, na), np.float32), _sorted(rng, (rows, nb), np.float32)
    ref_tel, port_tel = ref_spans.Telemetry(), port_spans.Telemetry()
    with ref_spans.use(ref_tel):
        RD._record_merge_telemetry("distributed_merge", jnp.asarray(a), jnp.asarray(b),
                                   SimpleNamespace(shape={"x": p}), "x", kv=True)
    with port_spans.use(port_tel):
        D._record_merge_telemetry(na, nb, p, 4, True, rows)
    assert {k: c.value for k, c in port_tel.counters.items()} == {k: c.value for k, c in ref_tel.counters.items()}
    assert {k: g.last for k, g in port_tel.gauges.items()} == {k: g.last for k, g in ref_tel.gauges.items()}
