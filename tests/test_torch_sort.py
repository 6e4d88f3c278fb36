"""The port's sorts (K3, K4 and the core) against the JAX package, bit for bit.

The JAX side runs ``sort_round_pallas`` and the ``kernels.ops`` sorts with
their Pallas rounds in interpret mode, as the JAX package's own tests do on
the CPU.  The port runs on CPU tensors, whose wide rounds take K3's and
K4's plain versions.  The last test runs ``chip_smoke.py``'s merge-and-sort
phase on the CPU at a small size.

Float sorts with both -0.0 and +0.0 are held against the stable order of
the JAX package's ``total_order_keys`` run eagerly: under ``jit``, XLA
drops the ``x + 0.0`` with which that function folds -0.0 into +0.0, so
the reference's jitted sorts order -0.0 first, where its documented
contract (and its eager core) ties them and keeps their input order.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import merge_path as jax_core
from repro.kernels import ops as jax_ops
from repro.kernels.merge_path import sort_round_pallas
import repro_torch.core as core
from repro_torch.kernels import merge_path as km
from repro_torch.kernels import ops

M, TILE, LEAF = 512, 64, 8
BF16 = jnp.bfloat16


def _t(a):
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    x = np.asarray(x)
    return x.view({2: np.int16, 4: np.int32}[x.dtype.itemsize]) if x.dtype.kind in "fV" else x


def _same(got, want):
    got, want = _bits(got), _bits(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _keys(dtype, shape, rng, zeros=False):
    """Heavy duplicates, the dtype's extremes (iinfo.min/max, +-inf), and for
    floats -0.0/+0.0 only when ``zeros``."""
    x = np.round(rng.standard_normal(shape) * 4)
    flat = x.reshape(-1)
    flat[rng.random(flat.size) < 0.05] = np.inf
    flat[rng.random(flat.size) < 0.05] = -np.inf
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        return np.nan_to_num(x, posinf=info.max, neginf=info.min).astype(dtype)
    if zeros:
        z = flat == 0
        flat[z] = np.where(rng.random(z.sum()) < 0.5, -0.0, 0.0)
    else:
        flat[flat == 0] = 0.5
    return x.astype(np.float32).astype(dtype)


@pytest.mark.parametrize("dtype,width", [(np.int16, 32), (np.int32, 256)])
def test_sort_round_matches_pallas(dtype, width):
    rng = np.random.default_rng(width)
    keys = np.sort(_keys(dtype, (M // width, width), rng), axis=1).reshape(-1)
    keys[M // 2 : M // 2 + width] = np.iinfo(dtype).max  # a whole run of sentinel-equal keys
    xf = np.concatenate([keys, np.full(TILE, np.iinfo(dtype).max, dtype)])
    want = jax.jit(lambda x: sort_round_pallas(x, width, tile=TILE, leaf=LEAF, interpret=True))(jnp.asarray(xf))
    before = km.sort_round.launches
    _same(km.sort_round(_t(xf), width, tile=TILE, leaf=LEAF), want)
    _same(km.sort_round_ref(_t(xf), width, tile=TILE), want)
    assert km.sort_round.launches == before  # the CPU path launches nothing


@pytest.mark.parametrize(
    "fn,dtype,shape",
    [
        ("sort", np.int32, (100,)),
        ("sort_batched", np.int16, (3, 100)),
        ("sort_batched", BF16, (3, 100)),
    ],
)
def test_sorts_match_reference(fn, dtype, shape):
    x = _keys(dtype, shape, np.random.default_rng(len(shape)))
    want = getattr(jax_ops, fn)(jnp.asarray(x), tile=TILE, leaf=LEAF)
    _same(getattr(ops, fn)(_t(x), tile=TILE, leaf=LEAF), want)
    sort_core = core.merge_sort if len(shape) == 1 else core.merge_sort_batched
    _same(sort_core(_t(x)), want)


@pytest.mark.parametrize(
    "fn,key_dtype,value_dtype,shape",
    [
        ("sort_kv", np.float32, np.float32, (100,)),
        ("sort_kv_batched", np.int32, np.int32, (3, 100)),
    ],
)
def test_kv_sorts_match_reference(fn, key_dtype, value_dtype, shape):
    rng = np.random.default_rng(7)
    k = _keys(key_dtype, shape, rng)
    v = rng.permutation(np.prod(shape)).reshape(shape).astype(value_dtype)
    wk, wv = getattr(jax_ops, fn)(jnp.asarray(k), jnp.asarray(v), tile=TILE, leaf=LEAF)
    for gk, gv in (
        getattr(ops, fn)(_t(k), _t(v), tile=TILE, leaf=LEAF),
        (core.merge_sort_kv if len(shape) == 1 else core.merge_sort_kv_batched)(_t(k), _t(v)),
    ):
        _same(gk, wk)
        _same(gv, wv)


@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_float_sorts_keep_signed_zeros_in_input_order(dtype):
    """-0.0 and +0.0 tie: the sorts keep their input order, the stable order
    of the reference's eager ``total_order_keys`` (see the module docstring)."""
    x = _keys(dtype, (200,), np.random.default_rng(11), zeros=True)
    perm = np.argsort(np.asarray(jax_core.total_order_keys(jnp.asarray(x))), kind="stable")
    want = x[perm]
    _same(ops.sort(_t(x), tile=TILE, leaf=LEAF), want)
    _same(ops.sort_batched(_t(x)[None, :], tile=TILE, leaf=LEAF)[0], want)
    _same(core.merge_sort(_t(x)), want)
    idx = np.arange(200, dtype=np.int32)
    for ks, vs in (ops.sort_kv(_t(x), _t(idx), tile=TILE, leaf=LEAF), core.merge_sort_kv(_t(x), _t(idx))):
        _same(ks, want)
        np.testing.assert_array_equal(vs.numpy(), perm)


def test_core_argsort_and_topk():
    """Against numpy's stable argsort: the smallest index wins a tie."""
    rng = np.random.default_rng(5)
    x = _keys(np.int32, (200,), rng)
    np.testing.assert_array_equal(core.stable_argsort(_t(x)).numpy(), np.argsort(x, kind="stable"))
    xf = _keys(np.float32, (200,), rng)
    want = np.argsort(-xf, kind="stable")[:17]
    for gv, gi in (core.topk_desc(_t(xf), 17), core.topk(_t(xf), 17)):
        np.testing.assert_array_equal(gi.numpy(), want)
        _same(gv, xf[want])


def test_sort_round_rejects_other_integer_keys():
    xf = torch.zeros(M + TILE, dtype=torch.int64)
    with pytest.raises(TypeError, match="int16 or int32"):
        km.sort_round(xf, 64, tile=TILE)
    with pytest.raises(ValueError, match="unsupported device"):
        km.sort_round(torch.zeros(M + TILE, dtype=torch.int32, device="meta"), 64, tile=TILE)


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s merge-and-sort phase, on CPU tensors at a small
    size: every comparison it makes on the card passes here against the
    plain versions, and nothing is launched."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    km.reset_launches()
    out = smoke.phase_merge_sort(device="cpu", log2n=10, batch=(4, 2048), tile=TILE, leaf=LEAF)
    assert set(out) == {"merge", "merge_kv", "sort_round"}
    for entry in out.values():
        assert entry["max_abs_err"] == 0 and entry["launches"] == 0
    assert all(fn.launches == 0 for fn in km.WRAPPERS)
