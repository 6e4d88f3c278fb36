"""The port's kernel-backed top-k against the JAX reference, bit for bit.

The JAX side runs ``kernels.ops.topk_batched`` with its Pallas rounds in
interpret mode and ``core.topk_batched``; the port runs
``kernels.ops.topk_batched`` on CPU tensors, whose wide rounds take K4's
plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import topk_batched as jax_core_topk
from repro.kernels import ops as jax_ops
from repro_torch.core import topk_batched as core_topk
from repro_torch.kernels import ops

BF16 = jnp.bfloat16


def _rows(dtype, shape=(3, 500), seed=0):
    """Rows with ties, and for floats NaN, -0.0/+0.0 and +-inf; for ints iinfo.min/max."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        x = rng.integers(-5, 5, size=shape).astype(dtype)
        x[0, :4] = np.iinfo(dtype).min
        x[1, :4] = np.iinfo(dtype).max
        return x
    x = np.round(rng.standard_normal(shape) * 4).astype(np.float32)  # many ties
    x[0, :6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, np.nan]
    x[2, :] = 1.5  # an all-equal row
    return x.astype(dtype)


def _t(a):
    if a.dtype == BF16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(t):
    t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize]) if a.dtype.kind in "fV" else a


@pytest.mark.parametrize("dtype", [BF16, np.float32, np.int32])
def test_kernel_topk_matches_reference(dtype):
    x = _rows(dtype)
    k = 40
    wv, wi = jax_ops.topk_batched(jnp.asarray(x), k, tile=128)  # wide rounds: Pallas, interpret mode
    cv, ci = jax.jit(jax_core_topk, static_argnums=1)(jnp.asarray(x), k)
    gv, gi = ops.topk_batched(_t(x), k, tile=128)  # wide rounds: K4's plain version
    assert gi.dtype == torch.int32 and tuple(gi.shape) == (3, k)
    for v, i in ((wv, wi), (cv, ci)):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(i))
        np.testing.assert_array_equal(_bits(gv), _jbits(v))


@pytest.mark.parametrize("k", [1, 40, 500, 900])
def test_kernel_topk_matches_core_path(k):
    """Both port backends give the same candidates, including a full sort
    (k = n) and a k past the row width, which truncates."""
    x = _t(_rows(BF16, seed=k))
    gv, gi = ops.topk_batched(x, k, tile=64, leaf=8)
    cv, ci = core_topk(x, min(k, 500))
    assert torch.equal(gi, ci)
    assert torch.equal(gv.view(torch.int16), cv.view(torch.int16))


def test_kernel_topk_rejects_non_pow2_tile():
    with pytest.raises(ValueError, match="power of two"):
        ops.topk_batched(torch.zeros(2, 300), 5, tile=96)
