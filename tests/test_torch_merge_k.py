"""The port's k-way merges against the JAX package, bit for bit.

``kernels.ops.merge_k`` (the slice's path: ``ceil(log2 k)`` rounds of the
ragged batched merge, K7 on the card) is held against the JAX
``kernels.ops.merge_k`` with its rounds in interpret mode once, and
against the JAX core tournament elsewhere; the core k-way merges and the
fan-in-k sort against their JAX twins, jitted.  The port runs on CPU
tensors, where K7's wrapper takes its plain version.
"""

import jax
import numpy as np
import pytest
import torch

import repro.core as jax_core
from repro.kernels import ops as jax_ops
import repro_torch.core as core
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops

TILE, LEAF = 64, 8
K, N = 5, 60  # k not a power of two: the tournament pads with zero-length runs
LENS = np.array([60, 0, 41, 75, 9], np.int32)  # one empty run, one past the width


def runs_of(dtype, rng, k=K, n=N):
    """Sorted runs of duplicates, keys equal to the sentinel at their end,
    junk past each run's length."""
    x = np.sort(rng.integers(-6, 6, (k, n)), axis=1).astype(dtype)
    x[:, -n // 6 :] = np.iinfo(dtype).max
    for r, ln in enumerate(np.clip(LENS[:k], 0, n)):
        x[r, ln:] = rng.integers(-99, 99, n - ln)
    return x


def same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_ops_merge_k_matches_reference_kernel_rounds():
    """The slice as a whole: the port's tournament against the JAX one whose
    three rounds run the Pallas ragged kernel (interpret mode)."""
    x = runs_of(np.int32, np.random.default_rng(31))
    want = jax_ops.merge_k(x, LENS, tile=TILE, leaf=LEAF, interpret=True)
    km.reset_launches()
    same(ops.merge_k(torch.from_numpy(x), torch.from_numpy(LENS), tile=TILE, leaf=LEAF), want)
    same(core.merge_k(torch.from_numpy(x), torch.from_numpy(LENS)), want)
    assert km.merge_batched_ragged.launches == 0  # the CPU path launches nothing


@pytest.mark.parametrize("k,n", [(3, 37), (6, 61)])
def test_ops_merge_k_odd_widths_match_reference_kernel_rounds(k, n):
    """k = 3 (two rounds) and k = 6 (three) over run widths that are no
    multiple of 4, so every round's rows start off a 16-byte boundary; one
    run empty and one full."""
    rng = np.random.default_rng(33 + k)
    x = np.sort(rng.integers(-6, 6, (k, n)), axis=1).astype(np.int32)
    x[:, -n // 6 :] = np.iinfo(np.int32).max
    lens = rng.integers(0, n + 1, k).astype(np.int32)
    lens[0], lens[-1] = n, 0
    for r, ln in enumerate(lens):
        x[r, ln:] = rng.integers(-99, 99, n - ln)  # junk
    want = jax_ops.merge_k(x, lens, tile=TILE, leaf=LEAF, interpret=True)
    km.reset_launches()
    same(ops.merge_k(torch.from_numpy(x), torch.from_numpy(lens), tile=TILE, leaf=LEAF), want)
    same(core.merge_k(torch.from_numpy(x), torch.from_numpy(lens)), want)
    assert km.merge_batched_ragged.launches == 0


_jax_core_kway = jax.jit(lambda x, v, ln: (jax_core.merge_k(x, ln), jax_core.merge_k_kv(x, v, ln),
                                           jax_core.merge_k_onepass(x, ln), jax_core.merge_k(x),
                                           jax_core.merge_k_onepass(x)))


@pytest.mark.parametrize("k", [1, K])
def test_kway_merges_match_reference(k):
    rng = np.random.default_rng(32 + k)
    x = runs_of(np.int16 if k == 1 else np.int32, rng, k)
    v = np.arange(k * N, dtype=np.int32).reshape(k, N)  # every value names its source slot
    ln = LENS[:k]
    w_merge, (w_k, w_v), w_one, w_full, w_one_full = _jax_core_kway(x, v, ln)
    tx, tv, tl = torch.from_numpy(x), torch.from_numpy(v), torch.from_numpy(ln)
    same(core.merge_k(tx, tl), w_merge)
    same(ops.merge_k(tx, tl, tile=TILE, leaf=LEAF), w_merge)
    got_k, got_v = core.merge_k_kv(tx, tv, tl)
    same(got_k, w_k)
    same(got_v, w_v)
    same(core.merge_k_onepass(tx, tl), w_one)
    same(core.merge_k(tx), w_full)
    same(ops.merge_k(tx, tile=TILE, leaf=LEAF), w_full)
    same(core.merge_k_onepass(tx), w_one_full)


def test_kway_merges_of_ragged_lists_match_reference():
    """A sequence of runs of different lengths: padded to the longest, and
    the output trimmed to the total."""
    rng = np.random.default_rng(40)
    runs = [np.sort(rng.standard_normal(n)).astype(np.float32) for n in (17, 0, 33, 5)]
    vals = [np.arange(len(r), dtype=np.int32) + 100 * i for i, r in enumerate(runs)]
    want = jax.jit(lambda rs, vs: (jax_core.merge_k(rs), jax_core.merge_k_kv(rs, vs), jax_core.merge_k_onepass(rs)))(runs, vals)
    t_runs, t_vals = [torch.from_numpy(r) for r in runs], [torch.from_numpy(v) for v in vals]
    same(core.merge_k(t_runs), want[0])
    for g, w in zip(core.merge_k_kv(t_runs, t_vals), want[1]):
        same(g, w)
    same(core.merge_k_onepass(t_runs), want[2])


def test_merge_sort_k_matches_reference():
    x = np.random.default_rng(41).integers(-20, 20, 29).astype(np.int32)  # rounds of fan-in 4, 4 and 2
    want = jax.jit(jax_core.merge_sort_k, static_argnums=1)(x, 4)
    same(core.merge_sort_k(torch.from_numpy(x), 4), want)


def test_kway_contract():
    """k = 1 with lengths still masks the tail; the fan-in must be a power
    of two; ``ops.merge_k`` takes a stacked tensor only."""
    x = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
    imax = torch.iinfo(torch.int32).max
    assert ops.merge_k(x, torch.tensor([2])).tolist() == [1, 2, imax, imax]
    assert core.merge_k(x, 2).tolist() == [1, 2, imax, imax]
    with pytest.raises(ValueError, match="power of two"):
        core.merge_sort_k(x[0], 3)
    with pytest.raises(ValueError, match=r"\(k, n\)"):
        ops.merge_k([x[0], x[0]])
