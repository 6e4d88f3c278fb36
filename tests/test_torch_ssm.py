"""The port's selective scan and Mamba block against the JAX reference.

Inputs come from a numpy seed and go to both packages as the same numbers.
On the CPU the port's ``ssm_scan`` runs its plain version; it is held
against the reference's Pallas kernel ``ssm_scan_pallas`` (jitted, in
interpret mode) at the reference's own bound, ``rtol = atol = 3e-5`` in
float32 and ``3e-2`` with bfloat16 inputs (``tests/test_ssm_kernel.py``).
The Mamba block's functions are held against their JAX twins within
``1e-5`` in float32: the same operations, summed in another order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ssm_scan as jax_scan
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro_torch.configs import get_config
from repro_torch.kernels import ssm_scan as ks
from repro_torch.models import ssm
from repro_torch.models import transformer as tf

SCAN_TOL = dict(rtol=3e-5, atol=3e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


def _scan_inputs(bsz, s, d, st, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(0.0, rng.standard_normal((bsz, s, d))).astype(np.float32)  # softplus
    x = rng.standard_normal((bsz, s, d)).astype(np.float32)
    bm = rng.standard_normal((bsz, s, st)).astype(np.float32)
    cm = rng.standard_normal((bsz, s, st)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, st))).astype(np.float32)
    return dt, x, bm, cm, a


def _pallas(args, chunk, d_tile):
    fn = jax.jit(functools.partial(jax_scan.ssm_scan_pallas, chunk=chunk, d_tile=d_tile, interpret=True))
    return [np.asarray(t, np.float32) for t in fn(*args)]


@pytest.mark.parametrize("bsz,s,d,st,chunk,d_tile", [
    (1, 32, 16, 4, 8, 16),
    (2, 64, 32, 8, 16, 16),
    (2, 128, 48, 16, 32, 24),
    (1, 256, 8, 2, 256, 8),
])
def test_scan_matches_the_pallas_kernel(bsz, s, d, st, chunk, d_tile):
    args = _scan_inputs(bsz, s, d, st)
    want_y, want_h = _pallas([jnp.asarray(t) for t in args], chunk, d_tile)
    y, h = ks.ssm_scan(*(torch.from_numpy(t) for t in args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), want_y, **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), want_h, **SCAN_TOL)


def test_scan_bf16_inputs_match_the_pallas_kernel():
    args = _scan_inputs(2, 64, 32, 8)
    want_y, want_h = _pallas([jnp.asarray(t, jnp.bfloat16) for t in args], 16, 16)
    y, h = ks.ssm_scan(*(torch.from_numpy(t).to(torch.bfloat16) for t in args), chunk=16)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), want_y, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(h.numpy(), want_h, rtol=3e-2, atol=3e-2)


def test_checkpoints_are_the_states_at_chunk_starts():
    """S = 21 straddles chunks of 8: hstart holds ceil(21 / 8) = 3 states,
    each the reference oracle's final state of the prefix before it."""
    args = _scan_inputs(2, 21, 8, 4, seed=1)
    y, h, hstart = ks.ssm_scan(*(torch.from_numpy(t) for t in args), chunk=8, checkpoints=True)
    assert hstart.shape == (2, 3, 8, 4)
    np.testing.assert_array_equal(hstart[:, 0].numpy(), 0.0)
    for c in (1, 2):
        pre = [jnp.asarray(t[:, : 8 * c]) for t in args[:4]] + [jnp.asarray(args[4])]
        np.testing.assert_allclose(hstart[:, c].numpy(), np.asarray(jax_scan.ssm_scan_ref(*pre)[1]), **SCAN_TOL)
    y2, h2 = ks.ssm_scan(*(torch.from_numpy(t) for t in args), chunk=8)
    assert torch.equal(y, y2) and torch.equal(h, h2)


def test_wrapper_checks_and_counts_no_cpu_launch():
    dt, x, bm, cm, a = (torch.from_numpy(t) for t in _scan_inputs(1, 5, 8, 4))
    ks.ssm_scan.launches = 0
    ks.ssm_scan(dt, x, bm, cm, a)
    assert ks.ssm_scan.launches == 0
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ks.ssm_scan(dt.double(), x, bm, cm, a)
    with pytest.raises(ValueError, match="contiguous"):
        ks.ssm_scan(dt, x, bm.transpose(1, 2).contiguous().transpose(1, 2), cm, a)
    with pytest.raises(ValueError, match=r"\(D, st\)"):
        ks.ssm_scan(dt, x, bm, cm, a[:, :2].contiguous())
    with pytest.raises(TypeError, match="share a dtype"):
        ks.ssm_scan(dt, x, bm.to(torch.bfloat16), cm, a)
    assert ks.fused_hbm_bytes(2, 64, 32, 8) == jax_scan.fused_hbm_bytes(2, 64, 32, 8)
    assert ks.xla_scan_hbm_bytes(1, 4096, 8192, 16) == jax_scan.xla_scan_hbm_bytes(1, 4096, 8192, 16)


def _aligned(shape, dtype, offset=0):
    """A zero tensor of ``shape`` whose storage starts ``offset`` elements
    past a fresh (aligned) allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# (B, S, D, st), the dtypes of dt and x, chunk, checkpoints, the offset of x's storage in elements,
# and the message the rules raise with (None: K9 takes them)
KERNEL_RULE_CASES = [
    ((1, 5, 8, 16), torch.float32, torch.bfloat16, 128, False, 0, None),  # 8 bf16 = 16 bytes
    ((2, 3, 24, 8), torch.bfloat16, torch.bfloat16, 32, True, 0, None),
    ((1, 4, 4, 16), torch.float32, torch.float32, 64, True, 0, None),  # 4 float32 = 16 bytes
    ((1, 4, 4, 16), torch.float32, torch.bfloat16, 128, False, 0, "element size of x"),
    ((1, 4, 20, 16), torch.bfloat16, torch.float32, 128, False, 0, "element size of dt"),
    ((1, 4, 12, 8), torch.float32, torch.bfloat16, 128, False, 0, "element size of x"),
    ((1, 4, 8, 4), torch.float32, torch.bfloat16, 128, False, 0, "state width"),
    ((1, 4, 8, 16), torch.float32, torch.bfloat16, 48, True, 0, "multiple of 32"),
    ((1, 4, 8, 16), torch.float32, torch.bfloat16, 48, False, 0, None),  # no checkpoints: any chunk
    ((1, 4, 8, 16), torch.float32, torch.bfloat16, 128, False, 4, "16-byte aligned"),
]


@pytest.mark.parametrize("shape,dt_dtype,x_dtype,chunk,checkpoints,offset,raises", KERNEL_RULE_CASES)
def test_kernel_rules_on_cpu_shapes_and_dtypes(shape, dt_dtype, x_dtype, chunk, checkpoints, offset, raises):
    bsz, s, d, st = shape
    dt, x = _aligned((bsz, s, d), dt_dtype), _aligned((bsz, s, d), x_dtype, offset)
    bm, cm, a = _aligned((bsz, s, st), torch.bfloat16), _aligned((bsz, s, st), torch.bfloat16), _aligned((d, st), torch.float32)
    if raises is None:
        ks.check_kernel_rules(dt, x, bm, cm, a, chunk, checkpoints)
    else:
        with pytest.raises(ValueError, match=raises):
            ks.check_kernel_rules(dt, x, bm, cm, a, chunk, checkpoints)
    ks.ssm_scan.launches = 0
    ks.ssm_scan(dt, x, bm, cm, a, chunk=chunk, checkpoints=checkpoints)  # the CPU takes the plain version all the same
    assert ks.ssm_scan.launches == 0


def test_ref_checkpoints_at_chunk_32_and_128_agree():
    """The plain version's states at chunk starts of 32 and of 128 steps are
    the same states where the starts coincide (every fourth of 32), and the
    checkpoints change neither y nor h_final."""
    args = [torch.from_numpy(t) for t in _scan_inputs(2, 300, 8, 4, seed=3)]
    y32, h32, hs32 = ks.ssm_scan_ref(*args, chunk=32, checkpoints=True)
    y128, h128, hs128 = ks.ssm_scan_ref(*args, chunk=128, checkpoints=True)
    y, h = ks.ssm_scan_ref(*args, chunk=128)
    assert hs32.shape == (2, 10, 8, 4) and hs128.shape == (2, 3, 8, 4)
    assert torch.equal(hs32[:, ::4], hs128)
    for got in (y32, y128):
        assert torch.equal(got, y)
    for got in (h32, h128):
        assert torch.equal(got, h)


# ---------------------------------------------------------------------------
# the Mamba block, on one layer of reduced falcon-mamba (float32)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """Random float32 weights in the layout of the reference's ``mamba_init``."""
    jcfg = jax_get_config("falcon-mamba").reduced()
    layout = jax.eval_shape(lambda k: jax_ssm.mamba_init(k, jcfg, jnp.float32), jax.random.key(0))
    rng = np.random.default_rng(1)
    np_params = {k: (rng.standard_normal(v.shape) / np.sqrt(v.shape[0] if v.ndim > 1 else 10)).astype(np.float32)
                 for k, v in layout.items()}
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    tp = {k: torch.from_numpy(v) for k, v in np_params.items()}
    return jcfg, get_config("falcon-mamba").reduced(), jp, tp


def _act(*shape, seed=2):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _cfgs(block, backend):
    jcfg, cfg = block[0], block[1]
    return dataclasses.replace(jcfg, ssm_backend=backend), dataclasses.replace(cfg, ssm_backend=backend)


def test_causal_conv_matches_reference(block):
    jcfg, _, jp, tp = block
    x, st = _act(2, 9, jcfg.d_inner), _act(2, jcfg.ssm_conv - 1, jcfg.d_inner, seed=3)
    for state in (None, st):
        want = jax_ssm._causal_conv(jnp.asarray(x), jp["conv_w"], None if state is None else jnp.asarray(state))
        got = ssm._causal_conv(torch.from_numpy(x), tp["conv_w"], None if state is None else torch.from_numpy(state))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


@pytest.mark.parametrize("backend", ["scan", "fused"])
def test_ssm_apply_matches_reference(block, backend):
    jcfg, cfg = _cfgs(block, backend)
    b, s, di, st = 2, 19, jcfg.d_inner, jcfg.ssm_state
    args = list(_scan_inputs(b, s, di, st, seed=4))
    want = jax.jit(jax_ssm.ssm_apply, static_argnums=5)(*(jnp.asarray(t) for t in args), jcfg)
    got = ssm.ssm_apply(*(torch.from_numpy(t) for t in args), cfg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN_TOL)


def test_mamba_forward_matches_reference(block):
    jcfg, cfg, jp, tp = block
    x = _act(2, 11, jcfg.d_model, seed=5)
    want = jax.jit(jax_ssm.mamba_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(ssm.mamba_forward(tp, torch.from_numpy(x), cfg).numpy(), np.asarray(want), **BLOCK_TOL)


@pytest.mark.parametrize("s", [2, 13])  # s < k - 1 pads the conv state in front
def test_mamba_with_state_matches_reference(block, s):
    jcfg, cfg, jp, tp = block
    x = _act(2, s, jcfg.d_model, seed=6)
    want = jax.jit(jax_tf._mamba_with_state, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    got = tf._mamba_with_state(tp, torch.from_numpy(x), cfg)
    assert got[1].shape == (2, jcfg.ssm_conv - 1, jcfg.d_inner)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


def test_mamba_decode_matches_reference(block):
    jcfg, cfg, jp, tp = block
    x = _act(2, 1, jcfg.d_model, seed=7)
    conv = _act(2, jcfg.ssm_conv - 1, jcfg.d_inner, seed=8)
    h = _act(2, jcfg.d_inner, jcfg.ssm_state, seed=9)
    want = jax.jit(jax_ssm.mamba_decode, static_argnums=4)(jp, jnp.asarray(x), jnp.asarray(conv), jnp.asarray(h), jcfg)
    conv_t, h_t = torch.from_numpy(conv), torch.from_numpy(h)
    got = ssm.mamba_decode(tp, torch.from_numpy(x), conv_t, h_t, cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)
    np.testing.assert_array_equal(conv_t.numpy(), conv)  # the caller stores the new states
    cache = ssm.mamba_init_cache(cfg, 3, torch.float32, "cpu")
    jcache = jax_ssm.mamba_init_cache(jcfg, 3, jnp.float32)
    assert {k: (tuple(v.shape), str(v.dtype)[6:]) for k, v in cache.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in jcache.items()}
