"""The port's merges (K1, K2 and the core) against the JAX package, bit for bit.

The JAX side runs ``merge_pallas`` / ``merge_kv_pallas`` in interpret mode,
as the JAX package's own tests do on the CPU, and ``repro.core.merge`` /
``merge_kv``.  The port runs on CPU tensors: ``kernels.ops`` and the kernel
wrappers take K1's and K2's plain versions (the rank merges), which are
what ``chip_smoke.py`` holds the kernels against on the card.  Bits are
compared, so ``-0.0`` and ``+0.0`` count as different.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge_path as jax_core
from repro.kernels.merge_path import merge_kv_pallas, merge_pallas
import repro_torch.core as core
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops, ref

TILE, LEAF = 64, 8
BF16 = jnp.bfloat16


def _sorted_keys(dtype, family, n, rng):
    """One sorted side of a merge.  ``mixed``, in order: -inf or iinfo.min;
    heavy duplicates with -0.0 and +0.0 in one run (signs at random); a
    long run of one key; keys equal to the sentinel (+inf or iinfo.max).
    ``all_equal``: one key throughout."""
    x = np.full(n, 50.0)
    if family == "mixed":
        q = n // 4
        x[: n // 2] = np.sort(np.round(rng.standard_normal(n // 2) * 4))
        x[: n // 20] = -np.inf
        x[n - q :] = np.inf
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        return np.nan_to_num(x, posinf=info.max, neginf=info.min).astype(dtype)
    zeros = x == 0
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, -0.0, 0.0)
    return x.astype(np.float32).astype(dtype)


def _t(a):
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    """Comparable bits of a torch tensor or a JAX/numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize]) if x.dtype.kind in "fV" else x


def _same(got, want):
    got, want = _bits(got), _bits(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# The JAX core merge and the Pallas kernel in one XLA program per shape:
# one compile is faster than the eager wrapper's many.
_jax_merge = jax.jit(jax_core.merge)
_jax_merge_kv = jax.jit(jax_core.merge_kv)
_both_merge = jax.jit(lambda a, b: (jax_core.merge(a, b), merge_pallas(a, b, tile=TILE, leaf=LEAF, interpret=True)))
_both_merge_kv = jax.jit(
    lambda *x: (jax_core.merge_kv(*x), merge_kv_pallas(*x, tile=TILE, leaf=LEAF, interpret=True))
)

CASES = [  # (a dtype, b dtype, family, na, nb, run the Pallas kernel)
    (np.float32, np.float32, "mixed", 700, 500, True),
    (BF16, BF16, "mixed", 700, 500, True),
    (np.int16, np.int32, "mixed", 700, 500, True),  # promotion to int32, as JAX promotes
    (np.int32, np.int32, "all_equal", 600, 500, True),
    (np.float32, np.float32, "mixed", 0, 500, True),  # one empty side
    (np.int32, np.int32, "mixed", 500, 0, False),
    (np.float32, np.float32, "mixed", 20, 30, False),  # n <= tile: the core path in both packages
]


@pytest.mark.parametrize("da,db,family,na,nb,pallas", CASES)
def test_merge_matches_reference(da, db, family, na, nb, pallas):
    rng = np.random.default_rng(na * 7 + nb)
    a, b = _sorted_keys(da, family, na, rng), _sorted_keys(db, family, nb, rng)
    if pallas:
        want, kernel = _both_merge(jnp.asarray(a), jnp.asarray(b))
        _same(kernel, want)
    else:
        want = _jax_merge(jnp.asarray(a), jnp.asarray(b))
    ta, tb = _t(a), _t(b)
    before = km.merge.launches
    _same(ops.merge(ta, tb, tile=TILE, leaf=LEAF), want)
    _same(core.merge(ta, tb), want)
    _same(core.partitioned_merge(ta, tb, 7), want)
    if da == db:
        _same(km.merge(ta, tb, tile=TILE, leaf=LEAF), want)
        _same(km.merge_ref(ta, tb), want)
    assert km.merge.launches == before  # the CPU path launches nothing


def test_signed_zeros_keep_a_priority():
    """Equal keys of either sign: A's come first, whatever the sign."""
    a = np.array([0.0, -0.0, 1.0], np.float32)
    b = np.array([-0.0, 0.0, 0.0], np.float32)
    want = _jax_merge(jnp.asarray(a), jnp.asarray(b))  # the Pallas kernel's answer too
    assert np.signbit(np.asarray(want)).tolist() == [False, True, True, False, False, False]
    _same(ops.merge(_t(a), _t(b), tile=4, leaf=2), want)
    _same(km.merge(_t(a), _t(b), tile=4, leaf=2), want)


KV_CASES = [  # (key dtype, value dtype, family, na, nb, run the Pallas kernel)
    (np.int32, np.int32, "mixed", 700, 500, True),
    (np.float32, np.float32, "mixed", 500, 700, True),
    (BF16, np.int32, "all_equal", 600, 500, True),
    (np.int16, np.float32, "mixed", 500, 600, True),
    (np.int32, np.int32, "mixed", 20, 30, False),  # n <= tile: the core path in both packages
]


@pytest.mark.parametrize("dk,dv,family,na,nb,pallas", KV_CASES)
def test_merge_kv_matches_reference(dk, dv, family, na, nb, pallas):
    rng = np.random.default_rng(na * 5 + nb)
    ak, bk = _sorted_keys(dk, family, na, rng), _sorted_keys(dk, family, nb, rng)
    av = np.arange(na).astype(dv)  # every value names its source slot
    bv = np.arange(na, na + nb).astype(dv)
    jargs = [jnp.asarray(x) for x in (ak, av, bk, bv)]
    if pallas:
        (wk, wv), (pk, pv) = _both_merge_kv(*jargs)
        _same(pk, wk)
        _same(pv, wv)
    else:
        wk, wv = _jax_merge_kv(*jargs)
    targs = [_t(x) for x in (ak, av, bk, bv)]
    before = km.merge_kv.launches
    for gk, gv in (
        ops.merge_kv(*targs, tile=TILE, leaf=LEAF),
        core.merge_kv(*targs),
        km.merge_kv(*targs, tile=TILE, leaf=LEAF),
        km.merge_kv_ref(*targs),
    ):
        _same(gk, wk)
        _same(gv, wv)
    assert km.merge_kv.launches == before


def test_oracles_agree_on_integer_keys():
    """The stable-sort oracles of ``kernels.ref`` are the merge on integer keys."""
    rng = np.random.default_rng(3)
    a, b = _sorted_keys(np.int32, "mixed", 300, rng), _sorted_keys(np.int32, "mixed", 200, rng)
    av, bv = np.arange(300, dtype=np.int32), np.arange(300, 500, dtype=np.int32)
    _same(ref.merge_ref(_t(a), _t(b)), core.merge(_t(a), _t(b)))
    for g, w in zip(ref.merge_kv_ref(_t(a), _t(av), _t(b), _t(bv)), core.merge_kv(_t(a), _t(av), _t(b), _t(bv))):
        _same(g, w)


@pytest.mark.parametrize(
    "a,b,kwargs,error,match",
    [
        (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int16), {}, TypeError, "equal dtypes"),
        (torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), {}, TypeError, "dtype"),
        (torch.zeros(2, 4), torch.zeros(8), {}, ValueError, "1-D"),
        (torch.zeros(16)[::2], torch.zeros(8), {}, ValueError, "contiguous"),
        (torch.zeros(8), torch.zeros(8), {"tile": 8192}, ValueError, "tile"),
        (torch.zeros(8, device="meta"), torch.zeros(8, device="meta"), {}, ValueError, "unsupported device"),
    ],
)
def test_merge_kernel_rejects_bad_operands(a, b, kwargs, error, match):
    with pytest.raises(error, match=match):
        km.merge(a, b, **kwargs)


def test_merge_kv_kernel_rejects_bad_values():
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        km.merge_kv(k, torch.zeros(8, dtype=torch.int64), k, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="value shapes"):
        km.merge_kv(k, torch.zeros(7, dtype=torch.int32), k, torch.zeros(8, dtype=torch.int32))


def test_merge_refuses_pairs_without_a_promotion_rule():
    with pytest.raises(TypeError, match="promotion"):
        ops.merge(torch.zeros(300, dtype=torch.int32), torch.zeros(300, dtype=torch.float64))
