"""The port's Merge Path core against the JAX reference, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jb
from repro.core import merge_path as jmp
from repro_torch.core import batched as tb
from repro_torch.core import merge_path as tmp

BF16 = jnp.bfloat16


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bf16 moved as its bits."""
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize]) if a.dtype.kind in "fV" else a


def _special_floats(dtype, n=257, seed=0):
    """Random floats laced with -0.0, +0.0, NaNs of several payloads and
    signs, and +-inf.  No subnormals: XLA on the CPU flushes them to zero
    where PyTorch keeps them, a difference of the backends, not of the code."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 4).astype(np.float32)
    x[:8] = [-0.0, 0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-3, -1e-3]
    x = x.astype(dtype)
    ib = x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)
    if x.dtype.itemsize == 2:
        ib[8:10] = np.array([0x7F81, 0xFFC1], np.uint16).view(np.int16)  # signalling / negative NaN payloads
    else:
        ib[8:10] = np.array([0x7F800001, 0xFFC00001], np.uint32).view(np.int32)
    return x


@pytest.mark.parametrize("dtype", [np.int32, np.int16, np.float32, BF16])
def test_flip_desc_matches_reference(dtype):
    if np.dtype(dtype).kind == "i":
        info = np.iinfo(dtype)
        x = np.array([info.min, info.min + 1, -1, 0, 1, info.max - 1, info.max], dtype)
    else:
        x = _special_floats(dtype)
    want = np.asarray(jmp.flip_desc(jnp.asarray(x)))
    got = _np(tmp.flip_desc(_t(x)))
    assert got.dtype == want.dtype
    if np.dtype(dtype).kind == "i":
        np.testing.assert_array_equal(got, want)
    else:  # NaN payload bits are not part of the contract: XLA quiets them
        nan = np.isnan(want.astype(np.float32))
        np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
        np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("dtype", [np.float32, BF16])
def test_total_order_keys_matches_reference(dtype):
    x = _special_floats(dtype)
    want = np.asarray(jmp.total_order_keys(jnp.asarray(x)))
    got = tmp.total_order_keys(_t(x)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # -0.0 and +0.0 share a key; every NaN sorts last, above +inf
    assert got[0] == got[1]
    assert (got[[4, 5, 8, 9]] > got[2]).all()


def test_total_order_keys_passes_ints_through():
    x = np.array([np.iinfo(np.int32).min, -1, 0, np.iinfo(np.int32).max], np.int32)
    np.testing.assert_array_equal(tmp.total_order_keys(_t(x)).numpy(), np.asarray(jmp.total_order_keys(jnp.asarray(x))))


def _sorted_ints(rng, shape, lo=-20, hi=20, dtype=np.int32):
    x = np.sort(rng.integers(lo, hi, size=shape), axis=-1).astype(dtype)
    x[..., -2:] = np.iinfo(dtype).max  # payloads equal to the sentinel
    return x


@pytest.mark.parametrize("na,nb", [(37, 50), (64, 1), (1, 64), (16, 16)])
def test_diagonal_intersections_matches_reference(na, nb):
    rng = np.random.default_rng(na * 100 + nb)
    a, b = _sorted_ints(rng, na), _sorted_ints(rng, nb)
    diags = np.arange(na + nb + 1, dtype=np.int32)
    want = np.asarray(jmp.diagonal_intersections(jnp.asarray(a), jnp.asarray(b), jnp.asarray(diags)))
    got = tmp.diagonal_intersections(_t(a), _t(b), _t(diags))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_row", [False, True])
def test_diagonal_intersections_batched_matches_reference(per_row):
    rng = np.random.default_rng(1)
    a, b = _sorted_ints(rng, (5, 33)), _sorted_ints(rng, (5, 20))
    diags = rng.integers(0, 54, size=(5, 9) if per_row else (9,)).astype(np.int32)
    want = np.asarray(jb.diagonal_intersections_batched(jnp.asarray(a), jnp.asarray(b), jnp.asarray(diags)))
    got = tb.diagonal_intersections_batched(_t(a), _t(b), _t(diags))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("valid", [None, (40, 64), (0, 17), (64, 0)])
def test_window_intersections_matches_reference(valid):
    rng = np.random.default_rng(2)
    wa, wb = _sorted_ints(rng, 64, dtype=np.int16), _sorted_ints(rng, 64, dtype=np.int16)
    diags = np.arange(0, 64, 8, dtype=np.int32)
    if valid is None:
        want = jb.window_intersections(jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(diags))
        got = tb.window_intersections(_t(wa), _t(wb), _t(diags))
    else:
        va, vb = valid
        diags = np.minimum(diags, va + vb).astype(np.int32)
        want = jb.window_intersections(jnp.asarray(wa), jnp.asarray(wb), jnp.asarray(diags), jnp.int32(va), jnp.int32(vb))
        got = tb.window_intersections(_t(wa), _t(wb), _t(diags), va, vb)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_merge_kv_batched_matches_reference(dtype):
    rng = np.random.default_rng(3)
    ak, bk = _sorted_ints(rng, (4, 24), -3, 3, dtype), _sorted_ints(rng, (4, 24), -3, 3, dtype)
    av = rng.integers(0, 1000, size=(4, 24)).astype(np.int32)
    bv = rng.integers(0, 1000, size=(4, 24)).astype(np.int32)
    wk, wv = jax.jit(jb.merge_kv_batched)(*(jnp.asarray(v) for v in (ak, av, bk, bv)))
    gk, gv = tb.merge_kv_batched(*(_t(v) for v in (ak, av, bk, bv)))
    assert gk.dtype == _t(ak).dtype and gv.dtype == torch.int32
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("dtype", [np.float32, BF16, np.int32])
def test_core_topk_batched_matches_reference(dtype):
    rng = np.random.default_rng(4)
    if np.dtype(dtype).kind == "i":
        x = rng.integers(-4, 4, size=(3, 100)).astype(dtype)
        x[0, :3] = np.iinfo(dtype).min
    else:
        x = np.stack([_special_floats(dtype, 100, s) for s in range(3)])
    wv, wi = jax.jit(jb.topk_batched, static_argnums=1)(jnp.asarray(x), 17)
    gv, gi = tb.topk_batched(_t(x), 17)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(_bits(_np(gv)), _bits(np.asarray(wv)))
