"""The port's ragged merges, sorts and top-k (K7, K8 and the core) against
the JAX package, bit for bit; the segmented merges; the samplers' masked vocab.

The JAX side runs ``merge_batched_ragged_pallas`` /
``merge_kv_batched_ragged_pallas`` jitted in interpret mode beside its core
ragged merges, and its core ragged sorts and top-k jitted.  The port runs
on CPU tensors, where the kernel wrappers take their plain versions.
Float sorts and top-k use no signed zeros: the jitted reference orders
-0.0 before +0.0 (ROADMAP R4).  The tails past each row's length hold
unsorted junk, NaN among it: neither side may read them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jax_core
from repro.kernels.merge_path import merge_batched_ragged_pallas, merge_kv_batched_ragged_pallas
import repro_torch.core as core
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops
from repro_torch.serving import topk_sample, topp_sample

B, NA, NB, TILE, LEAF = 8, 70, 45, 64, 8  # (NA + NB) % TILE != 0
BF16 = jnp.bfloat16
# edge rows first (0/0, 0/full, full/0, full/full, past the row, negative), then random
A_LENS = np.array([0, 0, NA, NA, NA + 9, -3, 31, 64], np.int32)
B_LENS = np.array([0, NB, 0, NB, 3 * NB, 20, 44, 1], np.int32)


def ragged_rows(dtype, n, lens, rng):
    """Sorted valid prefixes of duplicates with keys equal to the sentinel
    at their end (and -0.0/+0.0 mixed among the zeros), junk past them."""
    rows = []
    for ln in np.clip(lens, 0, n):
        x = np.sort(np.round(rng.standard_normal(n) * 3))
        x[max(0, ln - ln // 4) :] = np.inf
        x[ln:] = rng.standard_normal(n - ln) * 1e3  # junk
        rows.append(x)
    x = np.stack(rows)
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        return np.nan_to_num(x, posinf=info.max, neginf=info.min).astype(dtype)
    x[:, ::11] = np.where(np.arange(n)[None, ::11] < np.clip(lens, 0, n)[:, None], x[:, ::11], np.nan)
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


_both_ragged = jax.jit(lambda *x: (jax_core.merge_batched_ragged(*x),
                                   merge_batched_ragged_pallas(*x, tile=TILE, leaf=LEAF, interpret=True)))
_both_ragged_kv = jax.jit(lambda *x: (jax_core.merge_kv_batched_ragged(*x),
                                      merge_kv_batched_ragged_pallas(*x, tile=TILE, leaf=LEAF, interpret=True)))


@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_merge_batched_ragged_matches_reference(dtype):
    rng = np.random.default_rng(21)
    a, b = ragged_rows(dtype, NA, A_LENS, rng), ragged_rows(dtype, NB, B_LENS, rng)
    want, kernel = _both_ragged(jnp.asarray(a), jnp.asarray(b), jnp.asarray(A_LENS), jnp.asarray(B_LENS))
    same(kernel, want)
    targs = [to_torch(x) for x in (a, b, A_LENS, B_LENS)]
    before = km.merge_batched_ragged.launches
    same(ops.merge_batched_ragged(*targs, tile=TILE, leaf=LEAF), want)
    same(ops.merge_batched_ragged(*targs, tile=4 * TILE, leaf=LEAF), want)  # one tile: the core path
    same(core.merge_batched_ragged(*targs), want)
    same(km.merge_batched_ragged(*targs, tile=TILE, leaf=LEAF), want)  # the kernel clamps the lengths itself
    same(km.merge_batched_ragged_ref(*targs), want)
    assert km.merge_batched_ragged.launches == before


@pytest.mark.parametrize("dk", [np.int32, np.float32])
def test_merge_kv_batched_ragged_matches_reference(dk):
    rng = np.random.default_rng(22)
    ak, bk = ragged_rows(dk, NA, A_LENS, rng), ragged_rows(dk, NB, B_LENS, rng)
    vals = np.arange(B * (NA + NB), dtype=np.int32).reshape(B, NA + NB)  # every value names its source slot
    av, bv = vals[:, :NA], vals[:, NA:]
    (wk, wv), (pk, pv) = _both_ragged_kv(*(jnp.asarray(x) for x in (ak, av, bk, bv, A_LENS, B_LENS)))
    same(pk, wk)
    same(pv, wv)
    targs = [to_torch(x) for x in (ak, av, bk, bv, A_LENS, B_LENS)]
    before = km.merge_kv_batched_ragged.launches
    for gk, gv in (ops.merge_kv_batched_ragged(*targs, tile=TILE, leaf=LEAF), core.merge_kv_batched_ragged(*targs),
                   km.merge_kv_batched_ragged(*targs, tile=TILE, leaf=LEAF), km.merge_kv_batched_ragged_ref(*targs)):
        same(gk, wk)
        same(gv, wv)
    assert km.merge_kv_batched_ragged.launches == before


SPAN = km.MERGE_ROWS_SPAN
# K7's edges: (name, na, nb, dtype, view offsets, the rows' lengths): rows of
# 0/0, 0/full, full/0 and totals that end on a span seam or one past it
_EDGES = [
    ("odd widths, views", 37, 26, np.int16, (1, 3), [(0, 0), (0, 26), (37, 0), (20, 11), (37, 26)]),
    ("width 2 mod 8", 41, 41, BF16, (0, 0), [(0, 0), (0, 41), (41, 0), (41, 41), (7, 60)]),
    ("seams, views", SPAN + 3, SPAN + 1, np.int32, (1, 3),
     [(0, 0), (0, SPAN + 1), (SPAN + 3, 0), (SPAN - 5, 5), (SPAN + 7, SPAN - 7), (SPAN, 1)]),
    ("lopsided", 1, 300, np.float32, (0, 0), [(1, 300), (0, 300), (1, 0), (1, 17)]),
]


@pytest.mark.parametrize("name,na,nb,dtype,offs,lens", _EDGES, ids=[e[0] for e in _EDGES])
def test_merge_batched_ragged_edges_match_reference(name, na, nb, dtype, offs, lens):
    """K7 at the edges of the row span merge, on views at any element offset
    with junk tails; rows past a few thousand elements against the JAX core
    alone."""
    rng = np.random.default_rng(27)
    al, bl = (np.array(x, np.int32) for x in zip(*lens))
    a, b = ragged_rows(dtype, na, al, rng), ragged_rows(dtype, nb, bl, rng)
    args = [jnp.asarray(x) for x in (a, b, al, bl)]
    if na + nb <= 128:
        want, kernel = _both_ragged(*args)
        same(kernel, want)
    else:
        want = jax.jit(jax_core.merge_batched_ragged)(*args)
    views = []
    for x, off in zip((a, b), offs):
        full = to_torch(np.concatenate([np.zeros((x.shape[0], off), x.dtype), x], axis=1))
        views.append(full[:, off:])
    targs = [*views, to_torch(al), to_torch(bl)]
    before = km.merge_batched_ragged.launches
    for got in (ops.merge_batched_ragged(*targs, tile=TILE, leaf=LEAF),
                km.merge_batched_ragged(*targs, tile=TILE, leaf=LEAF), km.merge_batched_ragged_ref(*targs)):
        same(got, want)
    assert km.merge_batched_ragged.launches == before


KV_SPAN = km.MERGE_ROWS_KV_SPAN
# K8's edges: (name, na, nb, key dtype, value dtype, view offsets of keys and
# values, the rows' lengths); 2-byte keys put their values' rows at other
# offsets of 16 bytes than their own
_KV_EDGES = [
    ("odd widths, views, 2-byte keys", 37, 26, np.int16, np.int32, (1, 3),
     [(0, 0), (0, 26), (37, 0), (20, 11), (37, 26)]),
    ("width 2 mod 8, views, bfloat16 keys", 41, 41, BF16, np.float32, (1, 3),
     [(0, 0), (0, 41), (41, 0), (41, 41), (7, 60)]),
    ("seams, views", KV_SPAN + 3, KV_SPAN + 1, np.int32, np.int32, (1, 3),
     [(0, 0), (0, KV_SPAN + 1), (KV_SPAN + 3, 0), (KV_SPAN - 5, 5), (KV_SPAN + 7, KV_SPAN - 7), (KV_SPAN, 1)]),
    ("seams, 2-byte keys", KV_SPAN // 2 + 1, KV_SPAN // 2, np.int16, np.float32, (0, 0),
     [(0, 0), (KV_SPAN // 2 + 1, KV_SPAN // 2), (KV_SPAN // 2, KV_SPAN // 2), (KV_SPAN // 2, KV_SPAN // 2 - 1)]),
    ("lopsided", 1, 300, np.float32, np.float32, (0, 0), [(1, 300), (0, 300), (1, 0), (1, 17)]),
]


@pytest.mark.parametrize("name,na,nb,dk,dv,offs,lens", _KV_EDGES, ids=[e[0] for e in _KV_EDGES])
def test_merge_kv_batched_ragged_edges_match_reference(name, na, nb, dk, dv, offs, lens):
    """K8 at the edges of its row span, keys and values on views at any
    element offset, junk tails; every value names its source slot; rows
    past a few thousand elements against the JAX core alone."""
    rng = np.random.default_rng(28)
    al, bl = (np.array(x, np.int32) for x in zip(*lens))
    ak, bk = ragged_rows(dk, na, al, rng), ragged_rows(dk, nb, bl, rng)
    vals = np.arange(len(lens) * (na + nb)).reshape(len(lens), na + nb).astype(dv)
    av, bv = vals[:, :na], vals[:, na:]
    args = [jnp.asarray(x) for x in (ak, av, bk, bv, al, bl)]
    if na + nb <= 128:
        (wk, wv), (pk, pv) = _both_ragged_kv(*args)
        same(pk, wk)
        same(pv, wv)
    else:
        wk, wv = jax.jit(jax_core.merge_kv_batched_ragged)(*args)
    views = []
    for x, off in zip((ak, av, bk, bv), (offs[0], offs[0], offs[1], offs[1])):
        full = to_torch(np.concatenate([np.zeros((x.shape[0], off), x.dtype), x], axis=1))
        views.append(full[:, off:])
    targs = [*views, to_torch(al), to_torch(bl)]
    before = km.merge_kv_batched_ragged.launches
    for gk, gv in (ops.merge_kv_batched_ragged(*targs, tile=TILE, leaf=LEAF),
                   km.merge_kv_batched_ragged(*targs, tile=TILE, leaf=LEAF), km.merge_kv_batched_ragged_ref(*targs)):
        same(gk, wk)
        same(gv, wv)
    assert km.merge_kv_batched_ragged.launches == before


def test_diagonal_intersections_ragged_matches_reference():
    rng = np.random.default_rng(23)
    a, b = ragged_rows(np.int32, NA, A_LENS, rng), ragged_rows(np.int32, NB, B_LENS, rng)
    total = np.clip(A_LENS, 0, NA) + np.clip(B_LENS, 0, NB)
    diags = np.minimum(np.arange(0, NA + NB + 1, 9, dtype=np.int32)[None, :], total[:, None])
    want = jax.jit(jax_core.diagonal_intersections_ragged)(a, b, A_LENS, B_LENS, diags)
    same(core.diagonal_intersections_ragged(*(to_torch(x) for x in (a, b, A_LENS, B_LENS, diags))), want)


W = 14  # row width of the ragged sorts: pads to 16
LENS = np.array([0, 1, 7, 13, W, W + 5], np.int32)


def sort_rows(dtype, rng):
    """Rows of many ties with the dtype's extremes, NaN and +-inf for
    floats; no signed zeros (R4)."""
    x = np.round(rng.standard_normal((len(LENS), W)) * 3)
    if np.dtype(dtype).kind == "i":
        x = x.astype(dtype)
        x[:, ::5] = np.iinfo(dtype).min
        x[:, 3::5] = np.iinfo(dtype).max
        return x
    x[x == 0] = 0.5
    x[:, ::5] = np.nan
    x[:, 3::5] = np.inf
    x[:, 4::5] = -np.inf
    return x.astype(dtype)


# the kv sort with an index payload is the reference's stable_argsort_batched_ragged
_jax_ragged_sorts = jax.jit(lambda x, v, ln: (jax_core.merge_sort_batched_ragged(x, ln),
                                              jax_core.merge_sort_kv_batched_ragged(x, v, ln),
                                              jax_core.topk_batched_ragged(x, 9, ln)))


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_ragged_sorts_and_topk_match_reference(dtype):
    rng = np.random.default_rng(24)
    x = sort_rows(dtype, rng)
    iota = np.broadcast_to(np.arange(W, dtype=np.int32), x.shape).copy()
    want_sort, (want_k, want_perm), (want_tv, want_ti) = _jax_ragged_sorts(x, iota, LENS)
    tx, tl = to_torch(x), to_torch(LENS)
    same(core.merge_sort_batched_ragged(tx, tl), want_sort)
    gk, gv = core.merge_sort_kv_batched_ragged(tx, to_torch(iota), tl)
    same(gk, want_k)
    same(gv, want_perm)
    same(core.stable_argsort_batched_ragged(tx, tl), want_perm)
    for got in (core.topk_batched_ragged(tx, 9, tl), ops.topk_batched_ragged(tx, 9, tl, tile=4, leaf=2)):
        same(got[0], want_tv)
        same(got[1], want_ti)


def test_ragged_topk_contract():
    """Masked slots: index -1 and the dtype's minimum; k past the row width
    truncates; a scalar length broadcasts."""
    x = torch.tensor([[3.0, 1.0, 2.0, 9.0], [5.0, 5.0, 5.0, 5.0]])
    vals, idx = ops.topk_batched_ragged(x, 9, torch.tensor([2, 0]))
    assert idx.tolist() == [[0, 1, -1, -1], [-1, -1, -1, -1]]
    assert vals[0, :2].tolist() == [3.0, 1.0] and bool(torch.isneginf(vals[0, 2:]).all())
    vals, idx = ops.topk_batched_ragged(x.to(torch.int16), 2, 3)
    assert idx.tolist() == [[0, 2], [0, 1]] and vals.dtype == torch.int16


@pytest.mark.parametrize("kv", [False, True])
def test_segmented_merges_match_reference(kv):
    rng = np.random.default_rng(25)
    a = np.sort(np.round(rng.standard_normal(53) * 3)).astype(np.float32)
    b = np.sort(np.round(rng.standard_normal(38) * 3)).astype(np.float32)
    a[-5:], b[-3:] = np.inf, np.inf  # keys equal to the pad
    av, bv = np.arange(53, dtype=np.int32), np.arange(53, 91, dtype=np.int32)
    if kv:
        want = jax.jit(jax_core.segmented_merge_kv, static_argnums=4)(a, av, b, bv, 16)
        got = core.segmented_merge_kv(*(to_torch(x) for x in (a, av, b, bv)), 16)
    else:
        want = (jax.jit(jax_core.segmented_merge, static_argnums=2)(a, b, 16),)
        got = (core.segmented_merge(to_torch(a), to_torch(b), 16),)
    for g, w in zip(got, want):
        same(g, w)
    same(got[0], core.merge(to_torch(a), to_torch(b)))


@pytest.mark.parametrize("sampler", ["topk", "topp"])
def test_samplers_keep_to_the_valid_vocab(sampler):
    """Masked ids are never drawn, a row with no valid token returns -1, the
    two backends agree, and a row padded past its length (length >= k) draws
    the same token as its truncation from the same generator state."""
    rng = np.random.default_rng(26)
    v, k = 300, 8
    logits = torch.from_numpy(rng.standard_normal((6, v)).astype(np.float32) * 3)
    logits[:, 200:] = 50.0  # the padded tail would win every draw if it were read
    lens = torch.tensor([200, 150, 9, 3, 0, 1])

    def draw(x, ln, backend, seed):
        gen = torch.Generator().manual_seed(seed)
        if sampler == "topk":
            return topk_sample(x, gen, k=k, temperature=0.7, vocab_lens=ln, backend=backend, tile=64)
        return topp_sample(x, gen, p=0.8, k_max=k, temperature=0.7, vocab_lens=ln, backend=backend, tile=64)

    for seed in range(5):
        ids = draw(logits, lens, "kernel", seed)
        assert torch.equal(ids, draw(logits, lens, "core", seed))
        assert ids[4] == -1 and ids[5] == 0
        assert bool(((ids[:4] >= 0) & (ids[:4] < lens[:4])).all())
        trunc = draw(logits[:1, :200].contiguous(), None, "kernel", seed)
        assert ids[0] == trunc[0]
