"""The port's falcon-mamba model (prefill and decode) against the JAX reference.

Both packages get one set of random float32 weights in the reference's
layout (``abstract_params``), made with numpy and handed over through
``repro_torch.convert``.  Logits and caches agree within ``atol = rtol =
1e-4`` in float32 (the matrix products and the scan sum in another
order), and greedy tokens are equal.  The reference runs jitted, its
fused scan in interpret mode.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import abstract_params as jax_abstract_params
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.serving import engine as jax_engine
from repro.train import steps as jax_steps
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.models import forward_decode, forward_prefill, init_caches, init_params
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import make_decode_step, make_prefill_step
from repro_torch.train.steps import _cast

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = 21  # straddles the reduced config's ssm_chunk of 8


def _cfgs(backend):
    return (dataclasses.replace(get_config("falcon-mamba").reduced(), ssm_backend=backend),
            dataclasses.replace(jax_get_config("falcon-mamba").reduced(), ssm_backend=backend))


@pytest.fixture(scope="module")
def weights():
    _, jcfg = _cfgs("fused")
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2] if s.ndim > 2 else 10))
                        .astype(s.dtype), jax_abstract_params(jcfg))
    tokens = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    return tree, jax.tree.map(jnp.asarray, tree), from_jax_params(_cfgs("fused")[0], tree, device="cpu"), tokens


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def test_config_copy_matches_reference():
    for cfg, jcfg in ((get_config("falcon-mamba"), jax_get_config("falcon-mamba")),
                      (get_config("falcon-mamba-7b").reduced(), jax_get_config("falcon-mamba-7b").reduced())):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()


def test_init_params_layout_matches_reference():
    cfg, jcfg = _cfgs("fused")
    ours = init_params(cfg, seed=0, device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jax_abstract_params(jcfg))

    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in p.items()}

    assert walk(ours) == want
    # the reference's deterministic leaves: A_log = log(1 .. state) per channel, D = 1
    st = cfg.ssm_state
    a_log = np.log(np.arange(1, st + 1, dtype=np.float32))
    np.testing.assert_allclose(ours["layers"]["mamba"]["A_log"].numpy(), np.broadcast_to(a_log, (cfg.num_layers, cfg.d_inner, st)),
                               rtol=1e-6)  # torch's and numpy's log may differ by an ulp
    np.testing.assert_array_equal(ours["layers"]["mamba"]["D"].numpy(), 1.0)


def test_from_jax_params_on_a_reduced_ssm_tree(weights):
    tree, _, params, _ = weights
    assert params["layers"]["mamba"]["A_log"].dtype == torch.float32 and params["layers"]["mamba"]["D"].dtype == torch.float32
    assert "attn" not in params["layers"]
    got = _np(params)
    jax.tree.map(np.testing.assert_array_equal, got, tree)


@pytest.mark.parametrize("backend", ["fused", "scan"])
def test_forward_prefill_matches_reference(weights, backend):
    _, jparams, params, tokens = weights
    cfg, jcfg = _cfgs(backend)
    jl, jc = jax.jit(lambda p, t: jax_forward_prefill(jcfg, p, {"tokens": t})[:2])(jparams, jnp.asarray(tokens))
    tl, tc, enc = forward_prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert enc is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    assert set(tc["sub0"]) == set(jc["sub0"]) == {"conv", "ssm"}
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(tc["sub0"][name].numpy(), np.asarray(jc["sub0"][name]), **TOL)


def test_prefill_then_decode_matches_reference(weights):
    _, jparams, params, tokens = weights
    cfg, jcfg = _cfgs("fused")
    jl, jc = jax.jit(lambda p, t: jax_forward_prefill(jcfg, p, {"tokens": t})[:2])(jparams, jnp.asarray(tokens))
    tl, tc, _ = forward_prefill(cfg, params, {"tokens": torch.from_numpy(tokens)})
    jdecode = jax.jit(lambda p, c, t, s: jax_forward_decode(jcfg, p, c, t, s))
    tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(4):
        pos = np.full((2,), PROMPT + step, np.int32)
        jl, jc = jdecode(jparams, jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = forward_decode(cfg, params, tc, torch.from_numpy(tok), torch.from_numpy(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
        np.testing.assert_allclose(tc["sub0"]["ssm"].numpy(), np.asarray(jc["sub0"]["ssm"]), **TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


def test_prefill_matches_stepping(weights):
    """Prefill through the fused scan against feeding the prompt one token
    at a time through decode: the same logits and states (1e-4)."""
    _, _, params, tokens = weights
    cfg, _ = _cfgs("fused")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    logits, pre = prefill(params, {"tokens": torch.from_numpy(tokens)})
    caches = init_caches(cfg, 2, PROMPT, device="cpu")
    for t in range(PROMPT):
        step_logits, caches = decode(params, caches, torch.from_numpy(tokens[:, t:t + 1]), torch.full((2,), t))
    np.testing.assert_allclose(step_logits.numpy(), logits.numpy(), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(caches["sub0"][name].numpy(), pre["sub0"][name].numpy(), **TOL)


def test_serve_steps_cast_like_reference():
    """The reference's rule: float32 leaves of rank > 1 go to the compute
    dtype, so the stacked A_log and D and the norm scales become bfloat16."""
    cfg = get_config("falcon-mamba-7b").reduced()
    jcfg = jax_get_config("falcon-mamba-7b").reduced()
    bf_cfg, bf_jcfg = dataclasses.replace(cfg, dtype="bfloat16"), dataclasses.replace(jcfg, dtype="bfloat16")
    want = jax.eval_shape(lambda p: jax_steps._cast(p, jnp.bfloat16), jax_abstract_params(bf_jcfg))
    got = _cast(init_params(bf_cfg, seed=0, device="cpu"), torch.bfloat16)
    flat = jax.tree.map(lambda s: str(s.dtype), want)

    def walk(p):
        return {k: walk(v) if isinstance(v, dict) else str(v.dtype).replace("torch.", "") for k, v in p.items()}

    assert walk(got) == flat
    assert flat["layers"]["mamba"]["A_log"] == "bfloat16" and flat["final_norm"] == "float32"


def test_engine_prefill_moves_the_other_slots_like_reference(weights):
    """ROADMAP R5: both engines prefill a slot by stepping decode over the
    whole batch, which also advances the SSM states of the other, active
    slot.  The port keeps the reference's behaviour until the runtime
    slice settles it: the states move in both, to the same values."""
    _, jparams, params, _ = weights
    cfg, jcfg = _cfgs("scan")
    engines = ((jax_engine.ServingEngine(jcfg, jparams, batch=2, max_seq=32), jax_engine.Request),
               (ServingEngine(cfg, params, batch=2, max_seq=32, device="cpu"), Request))
    states = []
    for eng, request in engines:
        eng._fill_slot(1, request(uid=0, prompt=np.array([5, 9, 17, 33], np.int32), max_new_tokens=4))
        before = {k: np.array(eng.caches["sub0"][k][:, 1]) for k in ("conv", "ssm")}
        eng._fill_slot(0, request(uid=1, prompt=np.array([7, 8, 9], np.int32), max_new_tokens=4))
        after = {k: np.array(eng.caches["sub0"][k][:, 1]) for k in ("conv", "ssm")}
        assert all(not np.array_equal(before[k], after[k]) for k in before)
        states.append(after)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(states[1][k], states[0][k], **TOL)


def test_attention_prefill_and_other_families_wait():
    """Attention prefill is ported, and no family waits any more: the
    dense, MoE, VLM-prefix and audio families prefill (the VLM with its
    prefix counted in the cache, the audio model with its ``enc_kv``)."""
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    for arch in ("tinyllama", "moonshot", "paligemma", "whisper"):
        cfg = get_config(arch).reduced()
        batch = {"tokens": tokens}
        if cfg.num_prefix_tokens:
            batch["prefix_emb"] = torch.zeros((1, cfg.num_prefix_tokens, cfg.d_model))
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
        logits, caches, enc_kv = forward_prefill(cfg, init_params(cfg, seed=0, device="cpu"), batch)
        assert logits.shape == (1, cfg.vocab_size) and caches["sub0"]["k"].shape[2] == 4 + cfg.num_prefix_tokens
        assert (enc_kv is None) != cfg.is_encoder_decoder


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s SSM phase, on CPU tensors at a small size (the
    reduced config): every check it makes on the card passes here against
    the plain versions, and nothing is launched."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    reset_launches()
    out = smoke.phase_ssm(device="cpu", reduce=True, prompt=PROMPT, new_tokens=3, step_prompt=9,
                          shapes=((1, 40), (2, 9)), d=24, st=8, edges=((1, 13, 40, 8),))
    assert out["launches"] == 0 and out["max_abs_err"] < 1e-5 and out["ms"] is None
    assert all(fn.launches == 0 for fn in WRAPPERS)
