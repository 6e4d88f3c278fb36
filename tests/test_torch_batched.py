"""The port's batched merges (K5, K6 and the core) against the JAX package, bit for bit.

The JAX side runs ``merge_batched_pallas`` / ``merge_kv_batched_pallas``
jitted in interpret mode, as the JAX package's own tests do on the CPU,
beside ``repro.core.merge_batched`` / ``merge_kv_batched`` in the same XLA
program.  The port runs on CPU tensors: ``kernels.ops`` and the kernel
wrappers take K5's and K6's plain versions (the core rank merges), which
are what ``chip_smoke.py`` holds the kernels against on the card.  Bits
are compared, so ``-0.0`` and ``+0.0`` count as different.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jax_bat
from repro.kernels.merge_path import merge_batched_pallas, merge_kv_batched_pallas
import repro_torch.core as core
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops

B, NA, NB, TILE, LEAF = 8, 70, 45, 64, 8  # (NA + NB) % TILE != 0
BF16 = jnp.bfloat16


def sorted_rows(dtype, n, rng, rows=B):
    """Sorted rows of heavy duplicates: -inf or iinfo.min first, -0.0 and
    +0.0 at random among the zeros, keys equal to the sentinel last."""
    x = np.sort(np.round(rng.standard_normal((rows, n)) * 3), axis=1)
    x[:, : n // 10] = -np.inf
    x[:, n - n // 5 :] = np.inf
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        return np.nan_to_num(x, posinf=info.max, neginf=info.min).astype(dtype)
    zeros = x == 0
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    return x.astype(np.float32).astype(dtype)


def to_torch(a):
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def bits(x):
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize]) if x.dtype.kind in "fV" else x


def same(got, want):
    got, want = bits(got), bits(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


_both_merge = jax.jit(lambda a, b: (jax_bat.merge_batched(a, b),
                                    merge_batched_pallas(a, b, tile=TILE, leaf=LEAF, interpret=True)))
_both_merge_kv = jax.jit(lambda *x: (jax_bat.merge_kv_batched(*x),
                                     merge_kv_batched_pallas(*x, tile=TILE, leaf=LEAF, interpret=True)))


@pytest.mark.parametrize("da,db", [(np.float32, np.float32), (BF16, BF16), (np.int16, np.int32)])
def test_merge_batched_matches_reference(da, db):
    rng = np.random.default_rng(11)
    a, b = sorted_rows(da, NA, rng), sorted_rows(db, NB, rng)
    want, kernel = _both_merge(jnp.asarray(a), jnp.asarray(b))
    same(kernel, want)
    ta, tb = to_torch(a), to_torch(b)
    before = km.merge_batched.launches
    same(ops.merge_batched(ta, tb, tile=TILE, leaf=LEAF), want)
    same(core.merge_batched(ta, tb), want)
    if da == db:
        same(km.merge_batched(ta, tb, tile=TILE, leaf=LEAF), want)
        same(km.merge_batched_ref(ta, tb), want)
    assert km.merge_batched.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("dk,dv", [(np.int32, np.int32), (np.float32, np.float32)])
def test_merge_kv_batched_matches_reference(dk, dv):
    rng = np.random.default_rng(12)
    ak, bk = sorted_rows(dk, NA, rng), sorted_rows(dk, NB, rng)
    vals = np.arange(B * (NA + NB)).reshape(B, NA + NB).astype(dv)  # every value names its source slot
    av, bv = vals[:, :NA], vals[:, NA:]
    (wk, wv), (pk, pv) = _both_merge_kv(*(jnp.asarray(x) for x in (ak, av, bk, bv)))
    same(pk, wk)
    same(pv, wv)
    targs = [to_torch(x) for x in (ak, av, bk, bv)]
    before = km.merge_kv_batched.launches
    for gk, gv in (ops.merge_kv_batched(*targs, tile=TILE, leaf=LEAF), core.merge_kv_batched(*targs),
                   km.merge_kv_batched(*targs, tile=TILE, leaf=LEAF), km.merge_kv_batched_ref(*targs)):
        same(gk, wk)
        same(gv, wv)
    assert km.merge_kv_batched.launches == before


@pytest.mark.parametrize("fn", ["merge_batched", "merge_kv_batched"])
def test_rows_are_read_at_their_stride(fn):
    """Every other row of a stack, as ``merge_k`` reads a round's output,
    merges as the same rows made contiguous; rows that fit one tile take
    the core path."""
    rng = np.random.default_rng(13)
    stack = to_torch(sorted_rows(np.int32, NA, rng, rows=2 * B))
    vals = torch.arange(2 * B * NA, dtype=torch.int32).view(2 * B, NA)
    if fn == "merge_batched":
        args = (stack[0::2], stack[1::2])
    else:
        args = (stack[0::2], vals[0::2], stack[1::2], vals[1::2])
    for tile in (TILE, 4 * TILE):  # one launch on the card; the core path
        got = getattr(ops, fn)(*args, tile=tile, leaf=LEAF)
        want = getattr(core, fn)(*(x.contiguous() for x in args))
        for g, w in zip(*((got, want) if isinstance(got, tuple) else ((got,), (want,)))):
            same(g, w)


SPAN = km.MERGE_ROWS_SPAN
# K5's edges: (name, na, nb, dtype, view offsets into each row's buffer);
# the rows past a few thousand elements are held against the JAX core alone
_EDGES = [
    ("total span - 1", SPAN // 2, SPAN // 2 - 1, np.int32, (0, 0)),
    ("total span", SPAN // 2, SPAN // 2, np.float32, (0, 0)),
    ("total span + 1", SPAN // 2 + 1, SPAN // 2, np.int16, (0, 0)),
    ("total between tile and span", (TILE + SPAN) // 6, (TILE + SPAN) // 3, BF16, (0, 0)),
    ("odd widths, views", 37, 26, np.int16, (1, 3)),
    ("width 2 mod 8, views", 41, 41, np.float32, (1, 3)),
    ("wide odd views", SPAN + 5, SPAN // 2 - 3, np.int32, (1, 3)),
    ("lopsided (1, n)", 1, 300, np.float32, (0, 0)),
    ("lopsided (n, 1)", 300, 1, np.int32, (0, 0)),
]


def row_views(x, off):
    """Rows of ``x`` as views that start ``off`` elements into each row of a
    contiguous buffer, so that rows start off a 16-byte boundary."""
    full = to_torch(np.concatenate([np.zeros((x.shape[0], off), x.dtype), x], axis=1))
    return full[:, off:]


_core_merge = jax.jit(jax_bat.merge_batched)


@pytest.mark.parametrize("name,na,nb,dtype,offs", _EDGES, ids=[e[0] for e in _EDGES])
def test_merge_batched_edges_match_reference(name, na, nb, dtype, offs):
    """K5 at the edges of the row span merge, on views at any element offset."""
    rng = np.random.default_rng(14)
    a, b = sorted_rows(dtype, na, rng, rows=3), sorted_rows(dtype, nb, rng, rows=3)
    if na + nb <= 128:
        want, kernel = _both_merge(jnp.asarray(a), jnp.asarray(b))
        same(kernel, want)
    else:
        want = _core_merge(jnp.asarray(a), jnp.asarray(b))
    ta, tb = row_views(a, offs[0]), row_views(b, offs[1])
    assert ta.stride(0) == na + offs[0] and ta.is_contiguous() == (offs[0] == 0)
    before = km.merge_batched.launches
    for got in (ops.merge_batched(ta, tb, tile=TILE, leaf=LEAF), km.merge_batched(ta, tb, tile=TILE, leaf=LEAF),
                km.merge_batched_ref(ta, tb)):
        same(got, want)
    assert km.merge_batched.launches == before


@pytest.mark.parametrize("a_first", [True, False])
def test_merge_batched_disjoint_rows_match_reference(a_first):
    """Every key of one side below every key of the other: one window of each
    block's pair is empty."""
    rng = np.random.default_rng(15)
    low_high = np.sort(rng.integers(-10**6, 10**6, (3, 2 * 700)), axis=1).astype(np.int32)
    low, high = low_high[:, :700], low_high[:, 700:]
    a, b = (low, high) if a_first else (high, low)
    want = _core_merge(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.from_numpy(low_high)[:, :700], torch.from_numpy(low_high)[:, 700:]
    ta, tb = (ta, tb) if a_first else (tb, ta)
    same(ops.merge_batched(ta, tb, tile=TILE, leaf=LEAF), want)
    same(km.merge_batched(ta, tb, tile=TILE, leaf=LEAF), want)


_core_merge_kv = jax.jit(jax_bat.merge_kv_batched)
KV_SPAN = km.MERGE_ROWS_KV_SPAN
# K6's edges: (name, na, nb, key dtype, value dtype, view offsets into each
# row's buffer, the values' too); 2-byte keys put their values' rows at other
# offsets of 16 bytes than their own
_KV_EDGES = [
    ("total span - 1", KV_SPAN // 2, KV_SPAN // 2 - 1, np.int32, np.int32, (0, 0)),
    ("total span", KV_SPAN // 2, KV_SPAN // 2, np.float32, np.float32, (0, 0)),
    ("total span + 1, 2-byte keys", KV_SPAN // 2 + 1, KV_SPAN // 2, np.int16, np.int32, (0, 0)),
    ("total between tile and span", (TILE + KV_SPAN) // 6, (TILE + KV_SPAN) // 3, BF16, np.float32, (0, 0)),
    ("odd widths, views, 2-byte keys", 37, 26, np.int16, np.int32, (1, 3)),
    ("width 2 mod 8, views, bfloat16 keys", 41, 41, BF16, np.float32, (1, 3)),
    ("wide odd views", KV_SPAN + 5, KV_SPAN // 2 - 3, np.int32, np.float32, (1, 3)),
    ("lopsided (1, n)", 1, 300, np.float32, np.int32, (0, 0)),
    ("lopsided (n, 1)", 300, 1, np.int16, np.int32, (0, 0)),
]


@pytest.mark.parametrize("name,na,nb,dk,dv,offs", _KV_EDGES, ids=[e[0] for e in _KV_EDGES])
def test_merge_kv_batched_edges_match_reference(name, na, nb, dk, dv, offs):
    """K6 at the edges of its row span, keys and values on views at any
    element offset; every value names its source slot."""
    rng = np.random.default_rng(16)
    ak, bk = sorted_rows(dk, na, rng, rows=3), sorted_rows(dk, nb, rng, rows=3)
    vals = np.arange(3 * (na + nb)).reshape(3, na + nb).astype(dv)
    av, bv = vals[:, :na], vals[:, na:]
    args = [jnp.asarray(x) for x in (ak, av, bk, bv)]
    if na + nb <= 128:
        (wk, wv), (pk, pv) = _both_merge_kv(*args)
        same(pk, wk)
        same(pv, wv)
    else:
        wk, wv = _core_merge_kv(*args)
    targs = [row_views(x, off) for x, off in zip((ak, av, bk, bv), (offs[0], offs[0], offs[1], offs[1]))]
    assert targs[1].stride(0) == targs[0].stride(0) == na + offs[0]
    before = km.merge_kv_batched.launches
    for gk, gv in (ops.merge_kv_batched(*targs, tile=TILE, leaf=LEAF), km.merge_kv_batched(*targs, tile=TILE, leaf=LEAF),
                   km.merge_kv_batched_ref(*targs)):
        same(gk, wk)
        same(gv, wv)
    assert km.merge_kv_batched.launches == before


@pytest.mark.parametrize("a_first", [True, False])
def test_merge_kv_batched_disjoint_rows_match_reference(a_first):
    """K6 with every key of one side below every key of the other."""
    rng = np.random.default_rng(17)
    low_high = np.sort(rng.integers(-10**6, 10**6, (3, 2 * 700)), axis=1).astype(np.int32)
    slots = np.arange(3 * 2 * 700, dtype=np.int32).reshape(3, 2 * 700)
    halves = [(low_high[:, :700], slots[:, :700]), (low_high[:, 700:], slots[:, 700:])]
    (ak, av), (bk, bv) = halves if a_first else halves[::-1]
    wk, wv = _core_merge_kv(*(jnp.asarray(x) for x in (ak, av, bk, bv)))
    tk, tv = torch.from_numpy(low_high), torch.from_numpy(slots)
    t_halves = [(tk[:, :700], tv[:, :700]), (tk[:, 700:], tv[:, 700:])]
    (tak, tav), (tbk, tbv) = t_halves if a_first else t_halves[::-1]
    for gk, gv in (ops.merge_kv_batched(tak, tav, tbk, tbv, tile=TILE, leaf=LEAF),
                   km.merge_kv_batched(tak, tav, tbk, tbv, tile=TILE, leaf=LEAF)):
        same(gk, wk)
        same(gv, wv)


def test_rows_kv_span_matches_the_kernel_source():
    """``MERGE_ROWS_KV_SPAN`` is K6's and K8's outputs per block in ``merge.cu``."""
    src = (Path(km.__file__).parent / "csrc" / "merge.cu").read_text()
    span = int(re.search(r"constexpr int kRowsKvSpan = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int kRowsThreads = (\d+);", src).group(1))
    assert span == km.MERGE_ROWS_KV_SPAN and span % threads == 0


def test_rows_span_matches_the_kernel_source():
    """``MERGE_ROWS_SPAN`` is K5's and K7's outputs per block in ``merge.cu``."""
    src = (Path(km.__file__).parent / "csrc" / "merge.cu").read_text()
    span = int(re.search(r"constexpr int kRowsSpan = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int kRowsThreads = (\d+);", src).group(1))
    assert span == km.MERGE_ROWS_SPAN and span % threads == 0


_BAD = [
    ((torch.zeros(2, 8, dtype=torch.int32), torch.zeros(2, 8, dtype=torch.int16)), TypeError, "equal keys dtypes"),
    ((torch.zeros(2, 8, dtype=torch.int64), torch.zeros(2, 8, dtype=torch.int64)), TypeError, "dtype"),
    ((torch.zeros(2, 8), torch.zeros(3, 8)), ValueError, "equal B"),
    ((torch.zeros(8), torch.zeros(8)), ValueError, "equal B"),
    ((torch.zeros(2, 16)[:, ::2], torch.zeros(2, 8)), ValueError, "unit element stride"),
    ((torch.zeros(2, 8, device="meta"), torch.zeros(2, 8, device="meta")), ValueError, "unsupported device"),
]


@pytest.mark.parametrize("args,error,match", _BAD)
def test_merge_batched_kernel_rejects_bad_operands(args, error, match):
    with pytest.raises(error, match=match):
        km.merge_batched(*args)


def test_merge_batched_kernel_rejects_bad_tiles_and_values():
    k = torch.zeros(2, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="tile"):
        km.merge_batched(k, k, tile=8192)
    with pytest.raises(TypeError, match="values dtype"):
        km.merge_kv_batched(k, k.long(), k, k.long())
    with pytest.raises(ValueError, match="value shapes"):
        km.merge_kv_batched(k, k[:, :7], k, k)
    with pytest.raises(ValueError, match="row strides"):
        km.merge_kv_batched(torch.zeros(4, 8, dtype=torch.int32)[0::2], k, k, k)


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s batched phase, on CPU tensors at a small size:
    every comparison it makes on the card passes here against the plain
    versions, and nothing is launched."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    km.reset_launches()
    out = smoke.phase_batched(device="cpu", log2n=7, bsz=6, log2_run=8, vocab=600, tile=TILE, leaf=LEAF)
    assert set(out) == {"merge_batched", "merge_kv_batched", "merge_batched_ragged", "merge_kv_batched_ragged"}
    for entry in out.values():
        assert entry["max_abs_err"] == 0 and entry["launches"] == 0
    assert all(fn.launches == 0 for fn in km.WRAPPERS)
