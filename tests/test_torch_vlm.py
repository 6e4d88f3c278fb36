"""The port's VLM family (paligemma-3b) against the JAX reference, and the
stand-ins every family shares.

Reduced paligemma (float32, 2 layers, d_model 64, a prefix of 8 patch
embeddings) on the reference's weights from ``jax.random.key(0)``, carried
over with ``repro_torch.convert``; tokens and prefix embeddings made with
numpy from a seed.  ``forward_train`` (the prefix's positions dropped
before the logits), ``forward_prefill`` with every cache and decode after
it at positions ``P + S ...`` agree within ``atol = rtol = 1e-4`` (the
matrix products sum in another order), greedy tokens are equal; one
``make_train_step`` from a converted state agrees within ``STEP_TOL``,
``prefix_proj``'s gradient too.  The bfloat16 gelu is the reference's bit
for bit (ROADMAP.md, R11).  ``abstract_params``, ``abstract_caches`` and
``abstract_train_state`` are meta tensors with the reference's shapes and
dtypes for every registered architecture at full width, and
``shape_applicable`` agrees.  The reference runs jitted; its outputs are
computed once per module.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.configs import shape_applicable as jax_shape_applicable
from repro.models import abstract_params as jax_abstract_params
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models.layers import mlp_apply as jax_mlp_apply
from repro.models.model import abstract_caches as jax_abstract_caches
from repro.train import steps as jax_steps
from repro_torch.configs import SHAPES, TrainConfig, get_config, list_archs, shape_applicable
from repro_torch.convert import from_jax_params, from_jax_train_state, to_numpy
from repro_torch.models import (abstract_caches, abstract_params, forward_decode, forward_prefill, forward_train,
                                init_params)
from repro_torch.models.layers import mlp_apply
from repro_torch.serving import Request, ServingEngine
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import abstract_train_state, make_train_step
from repro_torch.train.steps import loss_and_grads

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # a whole train step: the model's sums in another order
TCFG = dict(z_loss=1e-4, grad_clip=1.0, warmup_steps=2, total_steps=10)
S, CACHE_EXTRA, DECODE_STEPS = 12, 4, 4


def _cfgs():
    return get_config("paligemma").reduced(), jax_get_config("paligemma").reduced()


@functools.cache
def _reference():
    """The reference's weights, inputs and outputs (numpy): train logits,
    prefill logits and caches, each decode
    step's token, logits and caches, a train state at step 1 and the
    loss's gradient at its parameters."""
    cfg, jcfg = _cfgs()
    jp = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    p = cfg.num_prefix_tokens
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32),
             "prefix_emb": rng.standard_normal((2, p, cfg.d_model)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"tree": jax.tree.map(np.asarray, jp), "batch": batch,
           "train": np.asarray(jax.jit(lambda p_, b: jax_forward_train(jcfg, p_, b))(jp, jb))}
    cache_len = p + S + CACHE_EXTRA
    logits, caches, enc = jax.jit(lambda p_, b: jax_forward_prefill(jcfg, p_, b, cache_len=cache_len))(jp, jb)
    assert enc is None
    out["prefill"] = (np.asarray(logits), jax.tree.map(np.asarray, caches))
    step, decode = jax.jit(lambda p_, c, t, s: jax_forward_decode(jcfg, p_, c, t, s)), []
    for i in range(DECODE_STEPS):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)[:, None]
        logits, caches = step(jp, caches, jnp.asarray(tok), jnp.full((2,), p + S + i, jnp.int32))
        decode.append((tok, np.asarray(logits), jax.tree.map(np.asarray, caches)))
    out["decode"] = decode
    # a train state at step 1, and the loss's gradient at its parameters
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, -1] = -1
    out["train_batch"] = dict(batch, labels=labels)
    jtb = {k: jnp.asarray(v) for k, v in out["train_batch"].items()}
    params = jax.tree.map(lambda a: a.astype(np.float32), out["tree"])
    opt = {"m": jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), params),
           "v": jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape) * 1e-4).astype(np.float32), params)}
    out["start"] = {"step": np.ones((), np.int32), "params": params, "opt": opt}
    loss_fn = jax.jit(jax.value_and_grad(lambda p_: jax_steps.cross_entropy_loss(
        jax_forward_train(jcfg, jax_steps._cast(p_, jnp.float32), jtb), jtb["labels"], TCFG["z_loss"])[0]))
    loss, grads = loss_fn(jax.tree.map(jnp.asarray, params))
    out["grads"] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


def _params():
    return from_jax_params(_cfgs()[0], _reference()["tree"], device="cpu")


def _batch(**drop):
    return {k: torch.from_numpy(v) for k, v in _reference()["batch"].items() if k not in drop}


def _assert_caches_close(got, want):
    assert set(got) == set(want)
    for sub in want:
        assert set(got[sub]) == set(want[sub]), sub
        for name in want[sub]:
            assert tuple(got[sub][name].shape) == want[sub][name].shape, (sub, name)
            np.testing.assert_allclose(got[sub][name].numpy(), want[sub][name], **TOL, err_msg=f"{sub}/{name}")


def _layout(tree):
    return {k: _layout(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def test_config_copy_matches_reference():
    for reduce in (False, True):
        cfg, jcfg = get_config("paligemma"), jax_get_config("paligemma")
        if reduce:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()


def test_init_params_layout_matches_reference():
    cfg, _ = _cfgs()
    ours = init_params(cfg, seed=0, device="cpu")
    assert _layout(ours) == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), _reference()["tree"])
    assert tuple(ours["prefix_proj"].shape) == (cfg.d_model, cfg.d_model)


def test_forward_train_matches_reference():
    """The prefix's positions are dropped before the logits: (B, S, V)."""
    logits = forward_train(_cfgs()[0], _params(), _batch()).detach().numpy()
    want = _reference()["train"]
    assert logits.shape == want.shape == (2, S, 256)
    np.testing.assert_allclose(logits, want, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))


def test_batch_without_a_prefix_is_plain_causal():
    """Without ``prefix_emb`` a VLM batch is the text alone, causal, as in
    the reference: the logits of the same weights as a dense model, and a
    zero gradient for ``prefix_proj``."""
    cfg, _ = _cfgs()
    logits = forward_train(cfg, _params(), _batch(prefix_emb=None))
    dense = dataclasses.replace(cfg, family="dense", num_prefix_tokens=0)
    params = {k: v for k, v in _params().items() if k != "prefix_proj"}
    assert torch.equal(logits, forward_train(dense, params, _batch(prefix_emb=None)))
    assert not np.allclose(logits.detach().numpy(), _reference()["train"], **TOL)
    # its gradient reaches no prefix_proj: zeros, as jax.grad gives (the launcher trains such batches)
    batch = {k: torch.from_numpy(v) for k, v in _reference()["train_batch"].items() if k != "prefix_emb"}
    _, _, grads = loss_and_grads(cfg, TrainConfig(**TCFG), _params(), batch)
    assert not grads["prefix_proj"].any() and grads["embed"]["table"].any()


def test_forward_prefill_and_decode_match_reference():
    """Prefill of the prefix and the text, its logits and every cache (the
    prefix's positions in it), then decode steps at ``P + S + i``."""
    cfg, _ = _cfgs()
    ref, params = _reference(), _params()
    p = cfg.num_prefix_tokens
    logits, caches, enc = forward_prefill(cfg, params, _batch(), cache_len=p + S + CACHE_EXTRA)
    assert enc is None
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], **TOL)
    _assert_caches_close(caches, ref["prefill"][1])
    assert caches["sub0"]["k"].shape[2] == p + S + CACHE_EXTRA
    for i, (tok, want_logits, want_caches) in enumerate(ref["decode"]):
        logits, caches = forward_decode(cfg, params, caches, torch.from_numpy(tok), torch.full((2,), p + S + i))
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        np.testing.assert_array_equal(logits.numpy().argmax(-1), want_logits.argmax(-1))
        _assert_caches_close(caches, want_caches)


def test_train_step_matches_reference():
    """One ``make_train_step`` from a converted state at step 1: its loss
    and grad norm are the reference's loss and the norm of its gradient at
    the state's parameters, and every leaf of the gradient
    (``loss_and_grads``) is the reference's within ``STEP_TOL``,
    the prefix projection's among them."""
    cfg, _ = _cfgs()
    ref = _reference()
    want_loss, want_g = ref["grads"]
    state = from_jax_train_state(cfg, ref["start"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["train_batch"].items()}
    loss, _, grads = loss_and_grads(cfg, TrainConfig(**TCFG), state["params"], batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got_g = to_numpy(grads)
    assert float(np.abs(got_g["prefix_proj"]).max()) > 0
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_g), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=f"grad{jax.tree_util.keystr(path)}")
    state, metrics = make_train_step(cfg, TrainConfig(**TCFG))(state, batch)
    want_norm = np.sqrt(sum(np.sum(np.square(w.astype(np.float64))) for w in jax.tree.leaves(want_g)))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)
    assert int(state["step"]) == 2 and all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))


def test_bfloat16_gelu_mlp_is_bit_identical_to_reference():
    """ROADMAP.md R11: ``jax.nn.gelu`` rounds each of its steps in
    bfloat16, and so does the port's ``"gelu"``.  A bfloat16 ``mlp_apply``
    on 10^5 values is the reference's bit for bit; its products are exact
    in float32 (an identity, and small multiples of 1/16 on multiples of
    1/4), so only the activation could round otherwise.  The tanh form of
    ``F.gelu`` differs in about 43 % of them."""
    rng = np.random.default_rng(3)
    d, n = 64, 100_000 // 64 + 1
    eye = np.eye(d, dtype=np.float32)
    cases = ((eye, (rng.standard_normal((n, d)) * 3).astype(np.float32)),
             ((rng.integers(-4, 5, (d, d)) / 16).astype(np.float32), (rng.integers(-8, 9, (n, d)) / 4).astype(np.float32)))
    ref = jax.jit(lambda p, x: jax_mlp_apply(p, x, "gelu"))
    for wi, x in cases:
        want = np.asarray(ref({"wi": jnp.asarray(wi, jnp.bfloat16), "wo": jnp.asarray(eye, jnp.bfloat16)},
                              jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
        tp = {"wi": torch.from_numpy(wi).bfloat16(), "wo": torch.from_numpy(eye).bfloat16()}
        xb = torch.from_numpy(x).bfloat16()
        got = mlp_apply(tp, xb, "gelu")
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)
        tanh_form = torch.nn.functional.gelu(xb @ tp["wi"], approximate="tanh").float().numpy()
        assert (tanh_form != want).mean() > 0.3


def test_engine_serves_tokens_only():
    """The engine takes a VLM config as the reference's does: tokens only,
    no prefix."""
    cfg, _ = _cfgs()
    engine = ServingEngine(cfg, _params(), batch=2, max_seq=32, device="cpu")
    for uid in range(3):
        engine.submit(Request(uid=uid, prompt=np.arange(1, 9 + uid, dtype=np.int32), max_new_tokens=3, topk=8))
    assert engine.run_until_done().ok()
    assert sorted(engine.done) == [0, 1, 2] and all(len(r.generated) == 3 for r in engine.done.values())


# ---------------------------------------------------------------------------
# the dry run's stand-ins, every registered architecture at full width
# ---------------------------------------------------------------------------


def _meta_layout(tree):
    leaves = jax.tree.leaves(tree)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    return _layout(tree)


def _jax_layout(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), tree)


STANDINS = {
    "params": (lambda a: abstract_params(get_config(a)), lambda a: jax_abstract_params(jax_get_config(a))),
    "caches": (lambda a: abstract_caches(get_config(a), 2, 64), lambda a: jax_abstract_caches(jax_get_config(a), 2, 64)),
    "train_state": (lambda a: abstract_train_state(get_config(a), TrainConfig()),
                    lambda a: jax_steps.abstract_train_state(jax_get_config(a), JaxTrainConfig())),
}


@pytest.mark.parametrize("what", sorted(STANDINS))
@pytest.mark.parametrize("arch", list_archs())
def test_abstract_standins_match_reference(arch, what):
    ours, theirs = STANDINS[what]
    assert _meta_layout(ours(arch)) == _jax_layout(theirs(arch))


@pytest.mark.parametrize("arch", list_archs())
def test_shape_applicable_matches_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert [s.name for s in SHAPES] == [s.name for s in JAX_SHAPES]
    for shape, jshape in zip(SHAPES, JAX_SHAPES):
        assert shape_applicable(cfg, shape) == jax_shape_applicable(jcfg, jshape)
