"""The port's selective-scan backward (K10's plain version) and its autograd
Function against the JAX reference's ``custom_vjp``.

Inputs and cotangents come from a numpy seed and go to both packages as the
same numbers.  The reference differentiates ``ssm_scan_pallas`` (jitted, its
forward and backward Pallas kernels in interpret mode) with ``jax.vjp``; the
port runs ``ssm_scan_bwd`` on the checkpoints of its own forward, and
``SsmScanFunction`` through ``torch.autograd``.  Tolerances are the
reference's own for its backward against ``jax.grad`` of its oracle
(``tests/test_ssm_kernel.py``): ``rtol = atol = 2e-4`` in float32 and
``6e-2`` with bfloat16 inputs.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ssm_scan as jax_scan
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.kernels import ssm_scan as ks

F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=6e-2, atol=6e-2)

# (B, S, D, st, chunk, d_tile, dtype, seed, cotangent of h_final): the shapes of
# the reference's own gradient tests
CASES = {
    "straddle-and-d-tiles": (1, 33, 16, 4, 16, 8, "float32", 0, True),
    "single-chunk": (2, 16, 8, 2, 16, 8, "float32", 0, True),
    "bf16-inputs": (1, 40, 16, 4, 16, 16, "bfloat16", 3, True),
    "y-only-cotangent": (2, 12, 8, 4, 8, 8, "float32", 5, False),
}


def _case(name):
    bsz, s, d, st, chunk, d_tile, dtype, seed, with_dh = CASES[name]
    rng = np.random.default_rng(seed)
    dt = np.logaddexp(0.0, rng.standard_normal((bsz, s, d))).astype(np.float32)  # softplus
    x = rng.standard_normal((bsz, s, d)).astype(np.float32)
    bm = rng.standard_normal((bsz, s, st)).astype(np.float32)
    cm = rng.standard_normal((bsz, s, st)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, st))).astype(np.float32)
    wy = rng.standard_normal((bsz, s, d)).astype(np.float32)
    wh = rng.standard_normal((bsz, d, st)).astype(np.float32) if with_dh else np.zeros((bsz, d, st), np.float32)
    return (dt, x, bm, cm, a), wy, wh, chunk, d_tile, dtype


@functools.cache
def _reference(name):
    """The reference's five gradients of <y, wy> + <h_final, wh>, float32 numpy."""
    args, wy, wh, chunk, d_tile, dtype = _case(name)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(t, jdt) for t in args[:4]] + [jnp.asarray(args[4])]  # a stays float32, as in the model

    def grads(*ops):
        fn = functools.partial(jax_scan.ssm_scan_pallas, chunk=chunk, d_tile=d_tile, interpret=True)
        (y, h), vjp = jax.vjp(fn, *ops)
        return vjp((jnp.asarray(wy, y.dtype), jnp.asarray(wh)))

    return [np.asarray(g, np.float32) for g in jax.jit(grads)(*jargs)]


def _port_operands(name):
    args, wy, wh, chunk, _, dtype = _case(name)
    tdt = getattr(torch, dtype)
    ops = [torch.from_numpy(t).to(tdt) for t in args[:4]] + [torch.from_numpy(args[4])]
    return ops, torch.from_numpy(wy).to(tdt), torch.from_numpy(wh), chunk, dtype


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_plain_version_matches_the_pallas_backward(name):
    """``ssm_scan_bwd`` (the plain version of K10 on the CPU) on the port's own
    checkpoints against ``jax.vjp`` of ``ssm_scan_pallas``."""
    ops, dy, dh, chunk, dtype = _port_operands(name)
    _, _, hstart = ks.ssm_scan(*ops, chunk=chunk, checkpoints=True)
    got = ks.ssm_scan_bwd(*ops, hstart, dy, dh, chunk=chunk)
    assert all(g.dtype == torch.float32 for g in got)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, w in zip(got, _reference(name)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, **tol)


@pytest.mark.parametrize("name", list(CASES))
def test_function_gradients_match_the_pallas_backward(name):
    """``SsmScanFunction`` through ``torch.autograd``: the same loss's
    gradients, each in its operand's dtype, as the reference casts them."""
    ops, dy, dh, _, dtype = _port_operands(name)
    leaves = [t.clone().requires_grad_() for t in ops]
    y, h = ks.ssm_scan(*leaves, chunk=8)
    assert y.grad_fn is not None and "SsmScanFunction" in type(y.grad_fn).__name__
    loss = (y.float() * dy.float()).sum() + (h * dh).sum()
    grads = torch.autograd.grad(loss, leaves)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for g, op, w in zip(grads, ops, _reference(name)):
        assert g.dtype == op.dtype
        np.testing.assert_allclose(g.float().numpy(), w, **tol)


def test_checkpoint_interval_changes_no_number():
    """The backward from checkpoints every 8 steps and from one every 32 gives
    the same gradients: the interval moves memory and recompute only."""
    ops, dy, dh, _, _ = _port_operands("straddle-and-d-tiles")
    outs = []
    for chunk in (8, 32):
        _, _, hstart = ks.ssm_scan(*ops, chunk=chunk, checkpoints=True)
        outs.append(ks.ssm_scan_bwd(*ops, hstart, dy, dh, chunk=chunk))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_gradient_keeps_the_forward_alone():
    """Without a gradient the scan is K9 alone (no checkpoints, no Function);
    with one, the Function's forward keeps checkpoints every ``GRAD_CHUNK``."""
    ops, _, _, _, _ = _port_operands("single-chunk")
    y, _ = ks.ssm_scan(*ops, chunk=8)
    assert y.grad_fn is None
    with torch.no_grad():
        y, _ = ks.ssm_scan(*[t.clone().requires_grad_() for t in ops], chunk=8)
    assert y.grad_fn is None
    assert ks.GRAD_CHUNK == ks.TILE == 32


def test_checkpoints_with_a_gradient_raise():
    """``checkpoints=True`` returns outputs that carry no gradient, so asking
    for it on operands that need one raises on every device, and under
    ``torch.no_grad()`` it does not."""
    ops, _, _, _, _ = _port_operands("single-chunk")
    leaves = [t.clone().requires_grad_() for t in ops]
    with pytest.raises(ValueError, match="checkpoints=True carries no gradient"):
        ks.ssm_scan(*leaves, chunk=8, checkpoints=True)
    with torch.no_grad():
        y, _, hstart = ks.ssm_scan(*leaves, chunk=8, checkpoints=True)
    assert y.grad_fn is None and hstart.grad_fn is None


def test_bwd_wrapper_checks_and_counts_no_cpu_launch():
    ops, dy, dh, chunk, _ = _port_operands("straddle-and-d-tiles")
    _, _, hstart = ks.ssm_scan(*ops, chunk=chunk, checkpoints=True)
    reset_launches()
    ks.ssm_scan_bwd(*ops, hstart, dy, dh, chunk=chunk)
    assert ks.ssm_scan_bwd in WRAPPERS and ks.ssm_scan_bwd.launches == 0
    with pytest.raises(ValueError, match="hstart must be float32"):
        ks.ssm_scan_bwd(*ops, hstart[:, :1].contiguous(), dy, dh, chunk=chunk)
    with pytest.raises(ValueError, match="dh_final must be float32"):
        ks.ssm_scan_bwd(*ops, hstart, dy, dh.double(), chunk=chunk)
    with pytest.raises(ValueError, match="dy must be"):
        ks.ssm_scan_bwd(*ops, hstart, dy[:, :5], dh, chunk=chunk)
    with pytest.raises(ValueError, match="contiguous"):
        ks.ssm_scan_bwd(*ops, hstart, dy.transpose(1, 2).contiguous().transpose(1, 2), dh, chunk=chunk)
    assert ks.bwd_hbm_bytes(1, 4096, 8192, 16, 32) == jax_scan.bwd_hbm_bytes(1, 4096, 8192, 16, 32)
    assert ks.bwd_hbm_bytes(2, 21, 8, 4, 8, elem=4) == jax_scan.bwd_hbm_bytes(2, 21, 8, 4, 8, elem=4)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    return chip


def _bwd_operands(bsz, s, d, st, act, dy_dtype=None):
    """Zero operands of K10 in the model's dtypes (dt float32, the rest in
    ``act``; dy in ``dy_dtype`` when given), freshly allocated."""
    z = functools.partial(torch.zeros, dtype=act)
    return (torch.zeros((bsz, s, d)), z((bsz, s, d)), z((bsz, s, st)), z((bsz, s, st)), z((d, st)),
            torch.zeros((bsz, -(-s // ks.TILE), d, st)), torch.zeros((bsz, s, d), dtype=dy_dtype or act),
            torch.zeros((bsz, d, st)))


# (B, S, D, st), the activations' dtype, dy's dtype (None: the activations'),
# chunk, and the message K10's rules raise with (None: the kernel takes them)
BWD_RULE_CASES = [(edge, act, None, ks.TILE, None) for edge in _chip_smoke().BWD_EDGES
                  for act in (torch.bfloat16, torch.float32)] + [
    ((1, 4, 20, 16), torch.bfloat16, None, ks.TILE, "element size of x"),  # 40 bytes a row
    ((1, 4, 20, 16), torch.float32, torch.bfloat16, ks.TILE, "element size of dy"),
    ((1, 4, 20, 4), torch.float32, None, ks.TILE, "state width"),
    ((1, 40, 8, 16), torch.float32, None, 64, "checkpoints of chunk 32"),
]


@pytest.mark.parametrize("shape,act,dy_dtype,chunk,raises", BWD_RULE_CASES)
def test_bwd_kernel_rules_on_cpu_shapes_and_dtypes(shape, act, dy_dtype, chunk, raises):
    """K10's rules, K9's with dy's rows and its chunk, run on CPU tensors:
    every edge shape of the chip phase passes, a bfloat16 D = 20 does not."""
    ops = list(_bwd_operands(*shape, act, dy_dtype))
    if chunk != ks.TILE:
        ops[5] = torch.zeros((shape[0], -(-shape[1] // chunk), shape[2], shape[3]))
    if raises is None:
        ks.check_bwd_kernel_rules(*ops, chunk)
    else:
        with pytest.raises(ValueError, match=raises):
            ks.check_bwd_kernel_rules(*ops, chunk)
    ks.ssm_scan_bwd.launches = 0
    ks.ssm_scan_bwd(*ops, chunk=chunk)  # the CPU takes the plain version all the same
    assert ks.ssm_scan_bwd.launches == 0


def test_bwd_and_fwd_rules_refuse_the_same_operands():
    """What K9's rules refuse, K10's refuse too, with the same message."""
    ops = _bwd_operands(1, 4, 20, 16, torch.bfloat16)
    with pytest.raises(ValueError, match="element size of x") as fwd:
        ks.check_kernel_rules(*ops[:5], ks.TILE, True)
    with pytest.raises(ValueError, match="element size of x") as bwd:
        ks.check_bwd_kernel_rules(*ops, ks.TILE)
    assert str(fwd.value) == str(bwd.value)
