"""Gradients of the port's float sorts and top-k against the reference's ``custom_vjp``s.

The reference gives its kernel-backed float sorts and top-k a permutation
transpose as their backward (``repro/kernels/ops.py``: ``_sort_batched``,
``_sort_kv_batched``, ``_topk_batched``, ``_topk_batched_ragged``).  The
port gathers through the integer permutation its sort returns, so
autograd's backward of that gather is the same transpose.  These tests
hold the port's gradients (``kernels.ops`` on the plain versions of S1
and K4, and ``core.topk_batched``) against ``jax.vjp`` of the
reference's functions, jitted, bit for bit: a permutation moves each
cotangent once and adds nothing.  The keys repeat (a pool of five
values), so the gradient follows the stable order of equal keys.  The
reference's f64 finite-difference pin needs ``jax.experimental.enable_x64``,
which this JAX lacks (ROADMAP.md, R7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jax_core
from repro.kernels import ops as jax_ops
from repro_torch import core
from repro_torch.kernels import ops

K = 5
SHAPE = (3, 40)


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([-1.5, -0.25, 0.5, 2.0, 3.0], np.float32), size=shape)
    return x, rng.standard_normal(shape).astype(np.float32)


def _grad(fn, *args, ct):
    """The port's gradient of ``fn(*args)`` (a tensor or a tuple of them) with
    cotangents ``ct``, for each float argument."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    out = out if isinstance(out, tuple) else (out,)
    return [g.numpy() for g in torch.autograd.grad(out, ts, [torch.from_numpy(c) for c in ct])]


def _jax_grad(fn, *args, ct):
    return [np.asarray(g) for g in jax.jit(lambda a, c: jax.vjp(fn, *a)[1](c))(args, ct)]


CASES = {
    "sort_batched": (lambda x: ops.sort_batched(x), lambda x: jax_ops.sort_batched(x), 1),
    "sort_kv_batched": (lambda k, v: ops.sort_kv_batched(k, v), lambda k, v: jax_ops.sort_kv_batched(k, v), 2),
    "topk_batched": (lambda x: ops.topk_batched(x, K)[0], lambda x: jax_ops.topk_batched(x, K)[0], 1),
    "topk_batched_ragged": (lambda x: ops.topk_batched_ragged(x, K, torch.tensor([0, 3, 40]))[0],
                            lambda x: jax_ops.topk_batched_ragged(x, K, jnp.asarray([0, 3, 40], jnp.int32))[0], 1),
    "core.topk_batched": (lambda x: core.topk_batched(x, K)[0], lambda x: jax_core.topk_batched(x, K)[0], 1),
}


@pytest.mark.parametrize("name", CASES)
def test_gradient_matches_the_reference_custom_vjp(name):
    port, ref, nargs = CASES[name]
    x, v = _inputs(len(name))
    args = (x, v)[:nargs]
    outs = jax.eval_shape(ref, *args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(7)
    ct = tuple(rng.standard_normal(o.shape).astype(np.float32) for o in outs)
    got = _grad(port, *args, ct=ct)
    want = _jax_grad(ref, *args, ct=ct if nargs > 1 else ct[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if name == "topk_batched_ragged":  # row 0 has no valid slot: no gradient reaches it
        assert not got[0][0].any()
