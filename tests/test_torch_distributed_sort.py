"""The port's one-round sample sort against the reference, and phase 11 on the CPU.

The port side runs ``distributed_sort`` (and ``distributed_sort_local``) on
four gloo ranks spawned once for the module (``chip_smoke.start_dist_cases``:
CPU tensors, so ``local_sort="kernel"`` runs the kernels' plain versions).
The reference side runs ``repro.core.distributed.distributed_sort_local``
under ``jax.jit(jax.vmap(partial(body, axis_name="x"), axis_name="x"))`` on
this process's one CPU device, with its ``"core"`` local sort (a sort has
one answer, so the port's ``"kernel"`` local sort is held against it too).
Every rank's padded bucket, count and overflow flag is compared bit for
bit: int32 keys with ``iinfo.max`` payloads, a skewed input that overflows
at a small ``capacity_factor``, normal float32 keys (no subnormals, no
signed zeros: ROADMAP R2, R4).  The skewed input's overflow flag is the
body's, so its cases call ``distributed_sort_local``; the guarded
``distributed_sort`` on the same keys retries at twice the factor and is
held against the reference body there.  The guard's collective verdict
rides the same launch: NaN-laced keys (ROADMAP R10) and an ``exchange``
fault make every rank raise.  The reference's two combines give the same
padded buckets (its own ``tests/test_distributed.py`` holds them equal),
so its body runs once per dtype, ``"onepass"`` for int32 and
``"tournament"`` for float32, and both of the port's combines are held
against it.
"""

import functools
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as RD
from repro.runtime import faults as RF

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:  # the spawned ranks import chip_smoke by name
    sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

WORLD = 4
N = 1024  # 256 keys a rank
SMALL_CF = 0.5  # a capacity of 128 a bucket: uniform keys fit, skewed keys overflow
REF_COMBINE = {"int32_imax": "onepass", "int32_skew": "onepass", "float32": "tournament"}


def _inputs(rng):
    imax = rng.integers(-1000, 1000, N).astype(np.int32)
    imax[rng.choice(N, 40, replace=False)] = np.iinfo(np.int32).max  # payloads equal to the sentinel
    skew = rng.integers(-1000, 1000, N).astype(np.int32)
    skew[: N // 2] = 7  # one bucket takes most of a rank's keys
    floats = (rng.standard_normal(N) * 100).astype(np.float32)
    floats[floats == 0] = 1.0  # no signed zeros against the jitted reference (R4)
    return {"int32_imax": (imax, SMALL_CF), "int32_skew": (skew, SMALL_CF), "float32": (floats, 2.0)}


@functools.lru_cache(maxsize=None)
def _vmapped(cf, combine):
    """The reference body over a named axis on one device, jitted (LLVM's
    optimisation level changes no bit of a sort; level 0 only shortens the
    compiles)."""
    body = functools.partial(RD.distributed_sort_local, axis_name="x", capacity_factor=cf, local_sort="core",
                             combine=combine)
    return jax.jit(jax.vmap(body, axis_name="x"), compiler_options={"xla_backend_optimization_level": 0})


def _ref(x, cf, combine):
    out, count, overflow = _vmapped(cf, combine)(jnp.asarray(x.reshape(WORLD, -1)))
    return np.asarray(out), np.asarray(count), np.asarray(overflow)


SORT_CASES = [(data, local_sort, combine) for data in ("int32_imax", "int32_skew", "float32")
              for local_sort in ("core", "kernel") for combine in ("onepass", "tournament")]


def _nan_laced(rng):
    """R10's inputs: sorted float32 keys with NaNs laced in (the reference's
    ``nan_lace``, so the same positions as a ``nan`` fault's)."""
    a = np.sort(rng.standard_normal(N // 2).astype(np.float32))
    b = np.sort(rng.standard_normal(N // 2).astype(np.float32))
    x = (rng.standard_normal(N) * 100).astype(np.float32)
    return [RF.nan_lace(t, f"r10:{i}") for i, t in enumerate((a, b, x))]


def _cases(inputs):
    cases = []
    for data, local_sort, combine in SORT_CASES:
        x, cf = inputs[data]
        # the skewed keys overflow at SMALL_CF: the body's flag, not the guard's retry
        fn = "distributed_sort_local" if data == "int32_skew" else "distributed_sort"
        cases.append({"name": f"{data}_{local_sort}_{combine}", "fn": fn, "p": WORLD,
                      "args": [torch.from_numpy(x)], "shard": [1],
                      "kwargs": {"capacity_factor": cf, "local_sort": local_sort, "combine": combine}})
    skew, cf = inputs["int32_skew"]
    cases.append({"name": "guarded_skew", "fn": "distributed_sort", "p": WORLD, "args": [torch.from_numpy(skew)],
                  "shard": [1], "kwargs": {"capacity_factor": cf}})
    a, b, x = (torch.from_numpy(t) for t in inputs["nan"])
    cases.append({"name": "nan_merge", "fn": "distributed_merge", "p": WORLD, "args": [a, b], "shard": [1, 1],
                  "kwargs": {}})
    cases.append({"name": "nan_sort", "fn": "distributed_sort", "p": WORLD, "args": [x], "shard": [1],
                  "kwargs": {"local_sort": "kernel"}})
    clean = torch.from_numpy(inputs["float32"][0])
    cases.append({"name": "exchange_fault", "fn": "distributed_merge", "p": WORLD,
                  "args": [torch.sort(clean[: N // 2]).values, torch.sort(clean[N // 2:]).values], "shard": [1, 1],
                  "kwargs": {}, "plan": "exchange:distributed_merge:0:window"})
    for data in ("int32_imax", "float32"):
        x, cf = inputs[data]
        cases.append({"name": f"local_{data}", "fn": "distributed_sort_local", "p": WORLD,
                      "args": [torch.from_numpy(x)], "shard": [1], "kwargs": {"capacity_factor": cf}})
    cases.append({"name": "uneven", "fn": "distributed_sort", "p": WORLD,
                  "args": [torch.from_numpy(inputs["float32"][0][: N - 2])], "shard": [1], "kwargs": {}})
    cases.append({"name": "bad_combine", "fn": "distributed_sort", "p": WORLD,
                  "args": [torch.from_numpy(inputs["float32"][0])], "shard": [1], "kwargs": {"combine": "tree"}})
    return cases


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs(np.random.default_rng(2025))
    inputs["nan"] = _nan_laced(np.random.default_rng(10))
    cases = _cases(inputs)
    with tempfile.TemporaryDirectory() as tmp:
        ctx, out_dir = chip_smoke.start_dist_cases(cases, WORLD, tmp)
        refs = {data: _ref(*inputs[data], REF_COMBINE[data]) for data in REF_COMBINE}
        skew, cf = inputs["int32_skew"]
        refs["int32_skew_2x"] = _ref(skew, 2 * cf, "onepass")
        got = chip_smoke.dist_case_results(ctx, out_dir, cases, timeout=300)
    return got, refs


def _check_rank_outputs(outs, ref):
    ref_out, ref_count, ref_overflow = ref
    for r, res in enumerate(outs):
        assert "error" not in res, res.get("error")
        out, count, overflow = res["out"]
        np.testing.assert_array_equal(out.numpy(), ref_out[r])
        np.testing.assert_array_equal(count.numpy(), ref_count[r])
        assert bool(overflow) == bool(ref_overflow[r])


@pytest.mark.parametrize("data,local_sort,combine", SORT_CASES)
def test_sort_matches_the_reference_body(runs, data, local_sort, combine):
    got, refs = runs
    _check_rank_outputs(got[f"{data}_{local_sort}_{combine}"], refs[data])


@pytest.mark.parametrize("data", ["int32_imax", "float32"])
def test_sort_local_matches_the_reference_body(runs, data):
    got, refs = runs
    _check_rank_outputs(got[f"local_{data}"], refs[data])


@pytest.mark.parametrize("data", ["int32_imax", "float32"])
def test_sort_valid_prefixes_are_the_sorted_array(runs, data):
    got, _ = runs
    outs = [res["out"] for res in got[f"{data}_kernel_tournament"]]
    assert not any(bool(o[2]) for o in outs)
    valid = torch.cat([o[0][: int(o[1][0])] for o in outs])
    assert torch.equal(valid, torch.sort(valid, stable=True).values)
    assert valid.shape[0] == N


def test_skewed_keys_overflow_on_every_rank(runs):
    got, refs = runs
    assert bool(refs["int32_skew"][2].all())
    assert all(bool(res["out"][2]) for res in got["int32_skew_core_onepass"])


def test_guarded_sort_retries_at_twice_the_capacity(runs):
    """The skewed keys overflow the ``sample`` attempt; ``capacity-2x`` is
    the reference body at twice the factor, or, where that overflows too,
    every rank raises."""
    got, refs = runs
    if bool(refs["int32_skew_2x"][2].all()):
        assert all(res.get("error", "").startswith("VerificationError") for res in got["guarded_skew"])
    else:
        _check_rank_outputs(got["guarded_skew"], refs["int32_skew_2x"])
        assert got["guarded_skew"][0]["out"][0].shape[0] == 2 * refs["int32_skew"][0].shape[1]


@pytest.mark.parametrize("name", ["nan_merge", "nan_sort", "exchange_fault"])
def test_guard_raises_on_every_rank(runs, name):
    """NaN-laced keys (R10) and a corrupted window exchange: the collective
    verdict makes every rank raise ``VerificationError``, none hangs."""
    got, _ = runs
    assert len(got[name]) == WORLD
    assert all(res.get("error", "").startswith("VerificationError") for res in got[name]), got[name]


@pytest.mark.parametrize("name,match", [("uneven", "equal nonempty shards"), ("bad_combine", "combine must be")])
def test_sort_refuses_bad_calls_on_every_rank(runs, name, match):
    got, _ = runs
    assert all(match in res.get("error", "") for res in got[name])


@pytest.mark.parametrize("m,cf,cap", [(256, 2.0, 512), (256, 0.5, 128), (1000, 2.0, 2048), (3, 2.0, 128)])
def test_sort_capacity_rounds_up_to_128(m, cf, cap):
    from repro_torch.core.distributed import sort_capacity

    assert sort_capacity(m, cf) == cap
