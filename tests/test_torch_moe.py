"""The port's MoE layer (``repro_torch.models.moe``) against the JAX reference.

The dispatch positions of both merge-path backends and of the cumsum
ablation are held bit for bit against the reference's, over heavy
duplicates, rows of 1 to past 1024 slots (where the plain versions of
S1 and K4 both run) and ragged lengths from 0 to full; the reference runs
jitted, its ``"merge_path_pallas"`` route in interpret mode at one small
size.  ``moe_apply`` on reduced phi3.5-moe and moonshot in float32 within
``F32_TOL`` of the largest output (matrix products sum in another
order), with and without ragged token counts, with capacity drops and
without; in bfloat16 at k = 6 bit for bit (the combine's slot order, the
four-step silu); with tied router columns; from parameters through
``_cast``; its gradients against ``jax.vjp``.  Inputs are made with numpy
from a seed and handed to both packages; each reference output is
computed once per module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jm
from repro_torch.configs import get_config
from repro_torch.convert import _to_tensor
from repro_torch.models import moe
from repro_torch.train.steps import _cast

F32_TOL = 1e-5  # of the largest output
E = 64  # one expert count for every positions case: one compile per shape
SLOTS = (1, 1100)  # 1100 pads to 2048: the plain S1 at chunk 512, then two rounds of K4's plain version


def _t(x):
    return _to_tensor(np.asarray(x), torch.device("cpu"))


def _tree_t(tree):
    return {k: _tree_t(v) if isinstance(v, dict) else _t(v) for k, v in tree.items()}


def _flat(n, heavy, rng):
    """Three rows of expert ids: uniform over the E experts, or three ids only."""
    if heavy:
        return rng.choice(np.array([3, 17, 40], np.int32), size=(3, n)).astype(np.int32)
    return rng.integers(0, E, (3, n)).astype(np.int32)


@functools.cache
def _reference_positions(n):
    """The reference's positions (core backend, plain and ragged at lengths
    0, half and full, and the cumsum ablation) on both families of rows."""
    rng = np.random.default_rng(n)
    lens = np.array([0, n // 2, n], np.int32)
    run = jax.jit(lambda f, ln: (jm._positions_merge_path_batched(f, E), jm._positions_merge_path_batched(f, E, ln),
                                 jax.vmap(lambda r: jm._positions_cumsum(r, E))(f)))
    out = {}
    for heavy in (False, True):
        flat = _flat(n, heavy, rng)
        out[heavy] = (flat, lens, *(np.asarray(o) for o in run(flat, lens)))
    return out


@pytest.mark.parametrize("heavy", (False, True), ids=("uniform", "three_ids"))
@pytest.mark.parametrize("n", SLOTS)
@pytest.mark.parametrize("backend", ("core", "pallas"))
def test_positions_match_reference(backend, n, heavy):
    flat, lens, want, want_ragged, want_cumsum = _reference_positions(n)[heavy]
    ft = torch.from_numpy(flat)
    got = moe._positions_merge_path_batched(ft, E, backend=backend)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(moe._positions_merge_path_batched(ft, E, torch.from_numpy(lens), backend).numpy(),
                                  want_ragged)
    np.testing.assert_array_equal(moe._positions_cumsum(ft, E).numpy(), want_cumsum)
    np.testing.assert_array_equal(moe._positions_merge_path(ft[1], E).numpy(), want[1])
    np.testing.assert_array_equal(moe._positions_cumsum(ft[1], E).numpy(), want_cumsum[1])
    assert (want_ragged[0] == 2 ** 30).all()  # a row of length 0 routes nothing


def test_positions_match_the_pallas_route_in_interpret_mode():
    """The reference's ``"merge_path_pallas"`` route (its tile engine, in
    interpret mode) at 2 x 512 slots, ragged: the port's kernel route and
    core route give its positions."""
    rng = np.random.default_rng(5)
    flat = rng.integers(0, 4, (2, 512)).astype(np.int32)
    lens = np.array([0, 301], np.int32)
    want = np.asarray(jax.jit(lambda f, ln: jm._positions_merge_path_batched(f, 4, ln, backend="pallas"))(flat, lens))
    for backend in ("pallas", "core"):
        got = moe._positions_merge_path_batched(torch.from_numpy(flat), 4, torch.from_numpy(lens), backend)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ("phi35-moe", "moonshot", "phi35-moe-full", "moonshot-full"))
def test_capacity_matches_reference(arch):
    name, full = arch.removesuffix("-full"), arch.endswith("-full")
    cfg, jcfg = get_config(name), jax_get_config(name)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for cf in (0.5, 1.25, 8.0):
        for s in (1, 2, 7, 32, 100, 4096):
            assert moe.capacity(dataclasses.replace(cfg, capacity_factor=cf), s) == \
                jm.capacity(dataclasses.replace(jcfg, capacity_factor=cf), s)


def _cfgs(arch, **kw):
    return (dataclasses.replace(get_config(arch).reduced(), **kw),
            dataclasses.replace(jax_get_config(arch).reduced(), **kw))


def _weights(jcfg, dtype, rng):
    """One layer's MoE weights in the reference's layout (router float32)."""
    shapes = jax.eval_shape(lambda k: jm.moe_init(k, jcfg, jnp.dtype(dtype)), jax.random.key(0))
    return jax.tree.map(lambda s: np.asarray(jnp.asarray(rng.standard_normal(s.shape) / np.sqrt(s.shape[-2]),
                                                         s.dtype)), shapes)


# (capacity_factor, ragged token counts) per arch: drops and none, each with and without ragged rows
CASES = {"phi35-moe": ((0.5, True), (8.0, False)), "moonshot": ((0.5, False), (8.0, True))}


COUNTS = np.array([32, 19], np.int32)  # the ragged rows' valid tokens, of (2, 32)


@functools.cache
def _jit_apply(arch):
    """The reference's float32 moe_apply for each case of ``CASES``, one jit."""
    _, jcfg = _cfgs(arch)

    def run(p, xx, tc):
        return [jm.moe_apply(p, xx, dataclasses.replace(jcfg, capacity_factor=cf), tc if ragged else None)
                for cf, ragged in CASES[arch]]

    return jax.jit(run)


@functools.cache
def _reference_apply(arch):
    """The reference's outputs on one set of weights and inputs (2, 32, d)."""
    _, jcfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    tree = _weights(jcfg, "float32", rng)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    return tree, x, COUNTS, [np.asarray(o) for o in _jit_apply(arch)(tree, x, COUNTS)]


@pytest.mark.parametrize("dispatch", ("merge_path", "merge_path_pallas", "cumsum"))
@pytest.mark.parametrize("arch", ("phi35-moe", "moonshot"))
def test_moe_apply_float32_matches_reference(arch, dispatch):
    tree, x, counts, wants = _reference_apply(arch)
    cfg, _ = _cfgs(arch, moe_dispatch=dispatch)
    params, xt = _tree_t(tree), torch.from_numpy(x)
    for (cf, ragged), want in zip(CASES[arch], wants):
        got = moe.moe_apply(params, xt, dataclasses.replace(cfg, capacity_factor=cf),
                            torch.from_numpy(counts) if ragged else None)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL * np.abs(want).max(),
                                   err_msg=f"capacity_factor {cf}, ragged {ragged}")
        if ragged:  # padding tokens get no expert output (the shared expert still runs)
            routed = moe.moe_apply({k: v for k, v in params.items() if k != "shared"}, xt,
                                   dataclasses.replace(cfg, capacity_factor=cf), torch.from_numpy(counts))
            assert float(routed[1, counts[1]:].abs().max()) == 0.0
    # capacity 0.5 drops slots, 8.0 none: the two outputs differ
    assert not np.allclose(wants[0], wants[1])


@functools.cache
def _reference_bf16():
    """The reference's bfloat16 moe_apply at k = 6 (reduced moonshot with 8
    experts) at capacity 0.5 (drops), from bfloat16 router weights (what
    ``_cast`` hands the model)."""
    _, jcfg = _cfgs("moonshot", num_experts=8, experts_per_token=6)
    rng = np.random.default_rng(2)
    tree = _weights(jcfg, "bfloat16", rng)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 24, jcfg.d_model)), jnp.bfloat16))
    cast = dict(tree, router=np.asarray(jnp.asarray(tree["router"], jnp.bfloat16)))
    want = jax.jit(lambda p, xx: jm.moe_apply(p, xx, dataclasses.replace(jcfg, capacity_factor=0.5)))(cast, x)
    return tree, x, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dispatch", ("merge_path", "merge_path_pallas"))
def test_moe_apply_bfloat16_is_bit_identical_at_k6(dispatch):
    """The combine sums a token's six expert outputs in slot order in
    bfloat16, and silu rounds each of its steps, as the reference does:
    every element equal, with drops (capacity 0.5), from parameters
    through ``_cast`` (the router in bfloat16, run in float32)."""
    tree, x, want = _reference_bf16()
    cfg, _ = _cfgs("moonshot", num_experts=8, experts_per_token=6, moe_dispatch=dispatch, capacity_factor=0.5)
    params = _tree_t(tree)
    cast = _cast(params, torch.bfloat16)
    assert params["router"].dtype == torch.float32 and cast["router"].dtype == torch.bfloat16
    got = moe.moe_apply(cast, _t(x), cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_router_ties_go_to_the_lower_expert():
    """Tied router columns: the top-k order of ``jax.lax.top_k``, the lower
    expert id first, in ``_router_topk`` and through ``moe_apply``."""
    rng = np.random.default_rng(3)
    probs = rng.choice(np.array([0.05, 0.1, 0.2], np.float32), size=(5, 16))
    want_p, want_e = jax.lax.top_k(jnp.asarray(probs), 4)
    got_p, got_e = moe._router_topk(torch.from_numpy(probs), 4)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))

    cfg, jcfg = _cfgs("phi35-moe")
    tree = _weights(jcfg, "float32", rng)
    tree["router"] = np.array(tree["router"])
    tree["router"][:, 1] = tree["router"][:, 0]  # experts 0 and 1 tie on every token, as do 2 and 3
    tree["router"][:, 3] = tree["router"][:, 2]
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    wants = _jit_apply("phi35-moe")(tree, x, COUNTS)
    for (cf, ragged), want in zip(CASES["phi35-moe"], wants):
        want = np.asarray(want)
        got = moe.moe_apply(_tree_t(tree), torch.from_numpy(x), dataclasses.replace(cfg, capacity_factor=cf),
                            torch.from_numpy(COUNTS) if ragged else None)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=F32_TOL * np.abs(want).max())


def test_gradients_match_jax_vjp_and_the_routes_agree():
    """``moe_apply``'s gradients with respect to every weight and the input,
    with capacity drops, against ``jax.vjp`` of the reference within
    ``F32_TOL`` of the largest; the kernel route and the core route give
    the same bits; every gradient is nonzero."""
    cfg, jcfg = _cfgs("moonshot", capacity_factor=0.5)
    rng = np.random.default_rng(4)
    tree = _weights(jcfg, "float32", rng)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    want_p, want_x = jax.jit(lambda p, xx, ct: jax.vjp(lambda q, xq: jm.moe_apply(q, xq, jcfg), p, xx)[1](ct))(tree, x, dy)
    wants = jax.tree.leaves(want_p) + [want_x]

    def grads(dispatch):
        leaves = [t.requires_grad_() for t in jax.tree.leaves(_tree_t(tree))]
        params = jax.tree.unflatten(jax.tree.structure(tree), leaves)
        xt = torch.from_numpy(x).requires_grad_()
        y = moe.moe_apply(params, xt, dataclasses.replace(cfg, moe_dispatch=dispatch))
        return torch.autograd.grad(y, leaves + [xt], torch.from_numpy(dy))

    kern, core = grads("merge_path_pallas"), grads("merge_path")
    for g, c, w in zip(kern, core, wants):
        w = np.asarray(w)
        assert torch.equal(g, c)
        assert bool((g != 0).any())
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F32_TOL * max(np.abs(w).max(), 1e-30))


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 9, 8)).astype(np.float32)
    top_e = rng.integers(0, 8, (2, 9, 3)).astype(np.int32)
    want = float(jm.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(top_e), 8))
    got = moe.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(top_e), 8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


def test_moe_init_layout_and_stacking():
    """The reference's leaves and dtypes (router float32), stacked on a
    leading axis one layer at a time; an unknown dispatch raises."""
    cfg, jcfg = _cfgs("moonshot", dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    p = moe.moe_init(gen, cfg, torch.bfloat16, (3,))
    want = jax.eval_shape(lambda k: jm.moe_init(k, jcfg, jnp.bfloat16), jax.random.key(0))
    got_leaves, want_leaves = jax.tree.leaves_with_path(p), jax.tree.leaves_with_path(want)
    assert [k for k, _ in got_leaves] == [k for k, _ in want_leaves]
    for (path, g), (_, w) in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == (3,) + w.shape, path
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
    assert not torch.equal(p["wg"][0], p["wg"][1])  # each layer its own draw
    with pytest.raises(ValueError, match="moe_dispatch"):
        moe.moe_apply(p, torch.zeros((1, 2, cfg.d_model)), dataclasses.replace(cfg, moe_dispatch="onehot"))
