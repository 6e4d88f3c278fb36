"""The port's attention over a whole sequence against the JAX reference.

``_sdpa`` (dense masked), ``_blockwise`` (online softmax over KV chunks)
and ``attention`` (projections, rotary, the choice between the two) on
the same float32 inputs, made with numpy from a seed, agree with the
jitted reference within ``atol = rtol = 1e-5``: the einsums and the
softmax sum in another order in the two frameworks.  The cases cover the causal, full and prefix
masks, sliding windows, the logit softcap, grouped-query heads and a
sequence that is no multiple of the chunk (its padded tail masked).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.models import attention as attn

TOL = dict(atol=1e-5, rtol=1e-5)

# (kind, window, prefix_len, softcap, Sq, Sk, chunk)
CASES = [
    ("causal", 0, 0, 0.0, 40, 40, 16),  # 40 keys: the last chunk is 8 real keys and 8 of padding
    ("causal", 7, 0, 0.0, 40, 40, 16),  # sliding window: whole chunks masked for the late queries
    ("causal", 0, 0, 30.0, 33, 33, 8),  # softcap
    ("prefix", 0, 5, 0.0, 24, 24, 32),  # one chunk wider than the keys
    ("prefix", 6, 9, 20.0, 29, 29, 10),  # prefix, window and softcap together
    ("full", 0, 0, 0.0, 12, 37, 16),  # queries that start past 0, more keys than queries
]


def _qkv(sq, sk, kv=2, g=3, hd=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, kv, g, hd)).astype(np.float32)
    k = rng.standard_normal((2, sk, kv, hd)).astype(np.float32)
    v = rng.standard_normal((2, sk, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("kind,window,prefix_len,softcap,sq,sk,chunk", CASES)
def test_blockwise_and_sdpa_match_reference(kind, window, prefix_len, softcap, sq, sk, chunk):
    q, k, v = _qkv(sq, sk)
    qpos, kpos = np.arange(sk - sq, sk), np.arange(sk)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))

    def ref(q, k, v, qpos, kpos):
        mask = jax_attn._mask(qpos, kpos, kind, window, prefix_len)
        return (jax_attn._blockwise(q, k, v, qpos, kind, window, prefix_len, chunk, softcap), mask,
                jax_attn._sdpa(q, k, v, mask, softcap))

    want_b, jm, want_d = jax.jit(ref)(*map(jnp.asarray, (q, k, v, qpos, kpos)))
    got_b = attn._blockwise(tq, tk, tv, torch.from_numpy(qpos), kind, window, prefix_len, chunk, softcap)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), **TOL)
    tm = attn._mask(torch.from_numpy(qpos), torch.from_numpy(kpos), kind, window, prefix_len)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    got_d = attn._sdpa(tq, tk, tv, tm, softcap)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    # the two paths compute one function
    np.testing.assert_allclose(got_b.numpy(), got_d.numpy(), **TOL)


def _params(d, h, kv, hd, seed=1):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd), "wo": (h * hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("kind,window,prefix_len,softcap,force_blockwise,rope_theta", [
    ("causal", 0, 0, 0.0, False, 10_000.0),
    ("causal", 16, 0, 0.0, True, 10_000.0),
    ("prefix", 0, 6, 50.0, True, 1_000_000.0),
    ("causal", 0, 0, 0.0, True, 0.0),
])
def test_attention_matches_reference(kind, window, prefix_len, softcap, force_blockwise, rope_theta):
    d, h, kv, hd, s = 48, 6, 2, 16, 45
    p = _params(d, h, kv, hd)
    x = np.random.default_rng(2).standard_normal((2, s, d)).astype(np.float32)
    kw = dict(num_heads=h, num_kv=kv, head_dim=hd, rope_theta=rope_theta, kind=kind, window=window,
              prefix_len=prefix_len, chunk=16, softcap=softcap, force_blockwise=force_blockwise)
    want = jax.jit(functools.partial(jax_attn.attention, **kw))(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), positions=jnp.arange(s))
    got = attn.attention({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                         positions=torch.arange(s), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # self_attention's k and v are the rotated projections the cache takes
    out, k, v = attn.self_attention({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                                    positions=torch.arange(s), **kw)
    assert torch.equal(out, got) and k.shape == v.shape == (2, s, kv, hd)


def test_attention_goes_blockwise_past_the_threshold(monkeypatch):
    """Past ``FULL_ATTENTION_THRESHOLD`` keys ``attention`` takes the
    blockwise path, as the reference does; so does cross-attention
    (``kv=``), by the count of the encoder's keys."""
    calls = []
    real = attn._blockwise
    monkeypatch.setattr(attn, "_blockwise", lambda *a: calls.append(a[1].shape[1]) or real(*a))
    monkeypatch.setattr(attn, "FULL_ATTENTION_THRESHOLD", 20)
    p = {n: torch.from_numpy(a) for n, a in _params(32, 4, 2, 8).items()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 21, 32)).astype(np.float32))
    kw = dict(num_heads=4, num_kv=2, head_dim=8, rope_theta=10_000.0, chunk=8)
    attn.attention(p, x[:, :20], positions=torch.arange(20), **kw)
    assert calls == []
    attn.attention(p, x, positions=torch.arange(21), **kw)
    assert calls == [21]
    kv = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 1, 21, 2, 8)).astype(np.float32))
    attn.attention(p, x[:, :5], positions=torch.arange(5), kv=(kv[0, :, :20], kv[1, :, :20]), **kw)
    assert calls == [21]
    attn.attention(p, x[:, :5], positions=torch.arange(5), kv=(kv[0], kv[1]), **kw)
    assert calls == [21, 21]
