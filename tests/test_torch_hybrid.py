"""The port's dense and hybrid models over whole sequences against the JAX reference.

Reduced tinyllama, hymba (fused scan, one group of 2 layers), gemma3 and
yi: ``forward_train``,
``forward_prefill`` of a 40-token prompt (past the reduced sliding window
of 16, so the window layers' ring caches wrap) with its caches, and
decode after it.  Both packages get the same random float32 weights, made
with numpy from a seed and handed over through ``repro_torch.convert``.
Logits and caches agree within ``atol = rtol = 1e-4`` (the matrix
products sum in another order), greedy tokens are equal.  Two train steps
of tinyllama and hymba from a converted state agree within ``STEP_TOL``.
The reference runs jitted, its fused scan in interpret mode; each
reference output is computed once per module.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.models import abstract_params as jax_abstract_params
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.train import steps as jax_steps
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import from_jax_params, from_jax_train_state, to_numpy
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.models import forward_decode, forward_prefill, forward_train, init_caches
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import make_train_step
from repro_torch.train.steps import _cast, _rebuild, loss_and_grads

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # a whole train step: the model's sums in another order
TCFG = dict(z_loss=1e-4, grad_clip=1.0, warmup_steps=2, total_steps=10)
ARCHS = ("tinyllama", "hymba", "gemma3", "yi")
PROMPT, CACHE_LEN, DECODE_STEPS = 40, 48, 3  # the reduced window is 16


def _cfgs(arch):
    """The reduced configs; hymba's on the fused scan and cut from its group
    of 8 layers (7 window layers, 1 global) to one group of 2 (1 and 1),
    because the reference takes 3-5 s to trace and compile each of its
    functions per group of 8 on a CPU.  gemma3's group of 6 keeps the
    grouping of windows covered."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    if cfg.family == "hybrid":
        cfg, jcfg = (dataclasses.replace(c, ssm_backend="fused", num_layers=2, global_every=2) for c in (cfg, jcfg))
    return cfg, jcfg


def _weights(jcfg, rng):
    """Random float32 weights in the reference's layout, scaled by fan-in."""
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2] if s.ndim > 2 else 10))
                        .astype(s.dtype), jax_abstract_params(jcfg))


@functools.cache
def _reference(arch):
    """The reference's outputs on one set of weights and tokens: train
    logits, prefill logits and caches, then each decode step's logits and
    caches (numpy), with the weights and tokens."""
    _, jcfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    tree = _weights(jcfg, rng)
    tokens = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    train = np.asarray(jax.jit(lambda p, t: jax_forward_train(jcfg, p, {"tokens": t}))(jp, tokens))
    logits, caches, _ = jax.jit(lambda p, t: jax_forward_prefill(jcfg, p, {"tokens": t}, cache_len=CACHE_LEN))(
        jp, tokens)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, caches))
    decode, step = [], jax.jit(lambda p, c, t, s: jax_forward_decode(jcfg, p, c, t, s))
    for i in range(DECODE_STEPS):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)[:, None]
        logits, caches = step(jp, caches, jnp.asarray(tok), jnp.full((2,), PROMPT + i, jnp.int32))
        decode.append((tok, np.asarray(logits), jax.tree.map(np.asarray, caches)))
    return {"tree": tree, "tokens": tokens, "train": train, "prefill": prefill, "decode": decode}


def _params(arch):
    return from_jax_params(_cfgs(arch)[0], _reference(arch)["tree"], device="cpu")


def _assert_caches_close(got, want):
    assert set(got) == set(want)
    for sub in want:
        assert set(got[sub]) == set(want[sub]), sub
        for name in want[sub]:
            assert tuple(got[sub][name].shape) == want[sub][name].shape, (sub, name)
            np.testing.assert_allclose(got[sub][name].numpy(), want[sub][name], **TOL, err_msg=f"{sub}/{name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch):
    ref = _reference(arch)
    logits = forward_train(_cfgs(arch)[0], _params(arch), {"tokens": torch.from_numpy(ref["tokens"])})
    np.testing.assert_allclose(logits.detach().numpy(), ref["train"], **TOL)
    np.testing.assert_array_equal(logits.detach().numpy().argmax(-1), ref["train"].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_caches_match_reference(arch):
    cfg, _ = _cfgs(arch)
    ref = _reference(arch)
    logits, caches, enc = forward_prefill(cfg, _params(arch), {"tokens": torch.from_numpy(ref["tokens"])},
                                          cache_len=CACHE_LEN)
    assert enc is None
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], **TOL)
    np.testing.assert_array_equal(logits.numpy().argmax(-1), ref["prefill"][0].argmax(-1))
    _assert_caches_close(caches, ref["prefill"][1])
    windows = transformer._group_windows(cfg)
    for i, w in enumerate(windows):  # window layers hold a ring of 16, global ones the whole cache_len
        assert caches[f"sub{i}"]["k"].shape[2] == (min(w, CACHE_LEN) if w else CACHE_LEN)
    assert (0 in windows) and (cfg.family == "hybrid" or arch == "gemma3") == (16 in windows)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_after_prefill_matches_reference(arch):
    cfg, _ = _cfgs(arch)
    ref = _reference(arch)
    params = _params(arch)
    _, caches, _ = forward_prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])}, cache_len=CACHE_LEN)
    for i, (tok, want_logits, want_caches) in enumerate(ref["decode"]):
        logits, caches = forward_decode(cfg, params, caches, torch.from_numpy(tok), torch.full((2,), PROMPT + i))
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        np.testing.assert_array_equal(logits.numpy().argmax(-1), want_logits.argmax(-1))
        _assert_caches_close(caches, want_caches)


def test_hybrid_prefill_matches_stepping():
    """Prefill of reduced hymba against feeding the prompt one token at a
    time through decode: the same logits and caches (1e-4), the ring of
    the window layers wrapped the same way."""
    cfg, _ = _cfgs("hymba")
    params, tokens = _params("hymba"), torch.from_numpy(_reference("hymba")["tokens"])
    logits, pre, _ = forward_prefill(cfg, params, {"tokens": tokens}, cache_len=CACHE_LEN)
    caches = init_caches(cfg, 2, CACHE_LEN, device="cpu")
    for t in range(PROMPT):
        step_logits, caches = forward_decode(cfg, params, caches, tokens[:, t:t + 1], torch.full((2,), t))
    np.testing.assert_allclose(step_logits.numpy(), logits.numpy(), **TOL)
    _assert_caches_close(caches, to_numpy(pre))


# ---------------------------------------------------------------------------
# the hybrid sum order
# ---------------------------------------------------------------------------


def test_hybrid_layer_sums_its_branches_before_the_residual(monkeypatch):
    """A hybrid layer adds ``x + (attn + mamba)``, as the reference does,
    in ``_layer_fwd`` and ``_layer_decode`` alike.  With the branches
    patched to fixed bfloat16 outputs (x = 1, attn = mamba = 2^-8, half a
    bfloat16 ulp of 1 each) that is 1 + 2^-7, where ``(x + attn) + mamba``
    rounds to 1 twice."""
    cfg = dataclasses.replace(get_config("hymba").reduced(), dtype="bfloat16")
    shape = (1, 3, cfg.d_model)
    x = torch.ones(shape, dtype=torch.bfloat16)
    half_ulp = torch.full(shape, 2.0 ** -8, dtype=torch.bfloat16)
    assert torch.equal((x + half_ulp) + half_ulp, x)
    want = x + (half_ulp + half_ulp)
    assert not torch.equal(want, x)
    kv = torch.zeros((1, 3, cfg.num_kv_heads, cfg.resolved_head_dim), dtype=torch.bfloat16)
    monkeypatch.setattr(attn_mod, "self_attention", lambda *a, **k: (half_ulp, kv, kv))
    monkeypatch.setattr(ssm_mod, "mamba_forward", lambda *a, **k: half_ulp)
    monkeypatch.setattr(transformer, "mlp_apply", lambda p, h, act: torch.zeros_like(h))
    monkeypatch.setattr(model_mod, "mlp_apply", lambda p, h, act: torch.zeros_like(h))
    p = transformer.layer_params(transformer.init_params(cfg, seed=0, device="cpu")["layers"], 0)
    got, _ = transformer._layer_fwd(cfg, p, x, torch.arange(3), window=16, kind="causal", prefix_len=0)
    assert torch.equal(got, want)
    one = half_ulp[:, :1]
    cache = {k: v[0] for k, v in init_caches(cfg, 1, 8, device="cpu")["sub0"].items()}
    monkeypatch.setattr(attn_mod, "decode_attention", lambda *a, **k: (one, None, None))
    monkeypatch.setattr(ssm_mod, "mamba_decode", lambda p, h, conv, ssm, c: (one, conv, ssm))
    got = model_mod._layer_decode(cfg, p, x[:, :1], cache, torch.zeros(1, dtype=torch.int64), 16)
    assert torch.equal(got, want[:, :1])


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _batch(seq=24):
    tok = np.random.default_rng(1).integers(0, 256, (2, seq)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tok, "labels": labels}


def _start_state(jcfg):
    """A train state in the reference's layout at step 1, made with numpy."""
    rng = np.random.default_rng(4)
    params = _weights(jcfg, rng)
    opt = {"m": jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), params),
           "v": jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape) * 1e-4).astype(np.float32), params)}
    return {"step": np.ones((), np.int32), "params": params, "opt": opt}


def _train_cfgs(arch):
    """The train steps' configs: hymba's without remat, because the
    reference's remat adds half to its trace and compile time on a CPU
    (about 7 s against 4.6).  The remat changes no gradient
    (``test_dots_policy_...`` shows it bit for bit), so the port's remat
    path computes what this step checks."""
    cfg, jcfg = _cfgs(arch)
    if arch == "hymba":
        cfg, jcfg = (dataclasses.replace(c, remat=False) for c in (cfg, jcfg))
    return cfg, jcfg


@pytest.mark.parametrize("arch", ["tinyllama", "hymba"])
def test_two_train_steps_match_reference(arch):
    cfg, jcfg = _train_cfgs(arch)
    jtc = jax_base.TrainConfig(**TCFG)
    start = _start_state(jcfg)
    jstate = jax.tree.map(jnp.asarray, start)
    jstep = jax.jit(jax_steps.make_train_step(jcfg, jtc))
    state = from_jax_train_state(cfg, start, device="cpu")
    step = make_train_step(cfg, TrainConfig(**TCFG))
    batch = _batch()
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = step(state, batch)
        assert set(metrics) == set(jmetrics)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
        got, want = to_numpy(state), jax.tree.map(np.asarray, jstate)
        assert int(got["step"]) == int(want["step"])
        for part in ("params", "opt"):
            for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got[part]), jax.tree.leaves(want[part])):
                np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=f"{part}{jax.tree_util.keystr(path)}")


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_saves_the_products_and_changes_no_gradient():
    """``remat_policy="dots"`` gives the gradients of ``"full"`` (and of no
    remat) bit for bit; its backward recomputes no ``aten.mm`` (as many as without remat,
    where ``"full"`` recomputes the forward's) but does recompute the rest,
    attention's ``aten.bmm`` included."""
    cfg, _ = _cfgs("hymba")
    params = from_jax_params(cfg, _weights(_cfgs("hymba")[1], np.random.default_rng(5)), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(20).items()}
    grads, mm, bmm = {}, {}, {}
    for name, c in (("full", cfg), ("dots", dataclasses.replace(cfg, remat_policy="dots")),
                    ("none", dataclasses.replace(cfg, remat=False))):
        masters = [p.detach().requires_grad_() for p in tree_leaves(params)]
        logits = forward_train(c, _rebuild(params, masters), batch)
        loss = torch.nn.functional.cross_entropy(logits.flatten(0, 1), batch["labels"].long().flatten().clamp(min=0))
        with _CountOps() as ops:
            grads[name] = torch.autograd.grad(loss, masters)
        mm[name], bmm[name] = ops.counts.get(torch.ops.aten.mm.default, 0), ops.counts.get(torch.ops.aten.bmm.default, 0)
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(grads["dots"], grads["full"], grads["none"]))
    assert mm["dots"] == mm["none"] < mm["full"]
    assert bmm["none"] < bmm["dots"] == bmm["full"]
    _, _, g = loss_and_grads(dataclasses.replace(cfg, remat_policy="dots"), TrainConfig(), params, batch)
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(g))


# ---------------------------------------------------------------------------
# serving, and the chip phase on the CPU
# ---------------------------------------------------------------------------


def test_engine_serves_reduced_hybrid_on_the_cpu():
    cfg, _ = _cfgs("hymba")
    engine = ServingEngine(cfg, _cast(_params("hymba"), torch.float32), batch=2, max_seq=32, device="cpu")
    for uid in range(3):
        engine.submit(Request(uid=uid, prompt=np.arange(1, 20 + uid, dtype=np.int32), max_new_tokens=3, topk=8))
    assert engine.run_until_done().ok()
    assert sorted(engine.done) == [0, 1, 2] and all(len(r.generated) == 3 for r in engine.done.values())


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s attention phase on CPU tensors at the reduced
    size: every check it makes on the card passes here against the plain
    versions, and nothing is launched."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    reset_launches()
    out = smoke.phase_attention(device="cpu", reduce=True, prompt=40, new_tokens=3, step_prompt=20, train_seq=24,
                                steps=2, dense_prompt=24, serve_prompt=6, serve_new=2)
    assert out["k9"]["launches"] == 0 and out["k10"]["launches"] == 0 and out["k9"]["ms"] is None
    assert all(fn.launches == 0 for fn in WRAPPERS)
