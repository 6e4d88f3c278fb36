"""The port's dense model against the JAX reference on the same weights.

The weights come from the reference's seeded init and are handed over as
numpy arrays through ``repro_torch.convert``.  Logits agree within
``atol = rtol = 1e-4`` in float32: the matrix products sum in another
order in the two frameworks, so bit equality is not expected.  Greedy
tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import forward_decode as jax_forward_decode
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import attention as attn
from repro_torch.models import forward_decode, init_caches, init_params

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("tinyllama-1.1b").reduced()
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    params = from_jax_params(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


def test_config_copy_matches_reference():
    cfg, jcfg = get_config("tinyllama"), jax_get_config("tinyllama")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()


def test_init_params_layout_matches_reference(weights):
    cfg, _, jparams, _ = weights
    ours = init_params(cfg, seed=0, device="cpu")
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)

    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in p.items()}

    assert walk(ours) == shapes
    again = init_params(cfg, seed=0, device="cpu")
    assert torch.equal(ours["layers"]["attn"]["wq"], again["layers"]["attn"]["wq"])


def test_forward_decode_matches_reference(weights):
    cfg, jcfg, jparams, params = weights
    bsz, clen = 2, 16
    jcaches = jax_init_caches(jcfg, bsz, clen)
    caches = init_caches(cfg, bsz, clen, device="cpu")
    jdecode = jax.jit(lambda p, c, t, s: jax_forward_decode(jcfg, p, c, t, s))
    tok = np.array([[3], [200]], np.int32)
    pos = np.array([0, 5], np.int32)  # ragged positions, as the engine's slots have
    for step in range(4):
        jl, jcaches = jdecode(jparams, jcaches, jnp.asarray(tok), jnp.asarray(pos))
        tl, caches = forward_decode(cfg, params, caches, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
        np.testing.assert_allclose(caches["sub0"]["k"].numpy(), np.asarray(jcaches["sub0"]["k"]), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        pos = pos + 1


def test_sdpa_matches_reference():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 5, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    qpos, kpos = np.arange(2, 7), np.arange(7)
    for kind, window, softcap in (("causal", 0, 0.0), ("prefix", 3, 0.0), ("causal", 0, 30.0)):
        jm = jax_attn._mask(jnp.asarray(qpos), jnp.asarray(kpos), kind, window, 2)
        want = jax_attn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, softcap)
        tm = attn._mask(torch.from_numpy(qpos), torch.from_numpy(kpos), kind, window, 2)
        got = attn._sdpa(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), tm, softcap)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qkv_proj_matches_reference(weights):
    cfg, _, jparams, params = weights
    x = np.random.default_rng(1).standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    dims = (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)
    for want, got in zip(jax_attn.qkv_proj(jp, jnp.asarray(x), *dims), attn.qkv_proj(tp, torch.from_numpy(x), *dims)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_entry_points_refuse_a_silent_cpu(monkeypatch, weights):
    """With no card and no explicit device the entry points raise."""
    cfg = weights[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_caches(cfg, 1, 8)


def test_other_families_wait_for_a_later_slice():
    """No family waits any more.  The MoE family builds (its experts in
    place of the MLP); the VLM and audio families build with the
    reference's layout: a VLM's ``prefix_proj``, an audio model's
    ``encoder`` and its decoder layers' ``cross`` and ``cross_norm``, and
    the caches of both."""
    base = get_config("tinyllama-1.1b").reduced()
    moe_cfg = dataclasses.replace(base, family="moe", num_experts=4, experts_per_token=2)
    assert set(init_params(moe_cfg, device="cpu")["layers"]) == {"attn_norm", "attn", "moe", "ffn_norm"}
    assert set(init_caches(moe_cfg, 1, 8, device="cpu")["sub0"]) == {"k", "v"}

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tree.items()}

    for later in (dict(family="vlm", num_prefix_tokens=8), dict(family="audio", encoder_layers=2, encoder_seq=24)):
        cfg, jcfg = (dataclasses.replace(c, **later) for c in (base, jax_get_config("tinyllama-1.1b").reduced()))
        want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                            jax.eval_shape(lambda k: jax_init_params(jcfg, k), jax.random.key(0)))
        assert layout(init_params(cfg, device="cpu")) == want
        assert layout(init_caches(cfg, 1, 8, device="cpu")) == jax.tree.map(
            lambda a: (tuple(a.shape), str(a.dtype)), jax_init_caches(jcfg, 1, 8))
