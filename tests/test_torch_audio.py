"""The port's audio family (whisper-large-v3) against the JAX reference.

Reduced whisper (float32, 2 decoder and 2 encoder layers of d_model 64,
24 frames) on the reference's weights from ``jax.random.key(0)``, carried
over with ``repro_torch.convert``; tokens and frames made with numpy from
a seed.  The sinusoidal table, cross-attention over a whole sequence and
for one decode step, ``encoder_forward``, ``forward_train``,
``forward_prefill`` (logits, every cache, ``enc_kv``) and decode after it
agree within ``atol = rtol = 1e-4`` (the matrix products sum in another
order), greedy tokens are equal; one ``make_train_step`` from a converted
state agrees within ``STEP_TOL``, the gradients of the encoder and of the
decoder's cross-attention too.  ``chip_smoke.py``'s phase 13 runs here at
the reduced size.  The reference runs jitted; its outputs are computed
once per module.
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

from repro.configs import get_config as jax_get_config
from repro.models import attention as jax_attn
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models.layers import sinusoidal_positions as jax_sinusoidal_positions
from repro.train import steps as jax_steps
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import from_jax_params, from_jax_train_state, to_numpy
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.models import (encoder_forward, forward_decode, forward_prefill, forward_train, init_caches,
                                init_params)
from repro_torch.models import attention as attn
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.serving import Request, ServingEngine
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_train_step
from repro_torch.train.steps import loss_and_grads

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # a whole train step: the model's sums in another order
TCFG = dict(z_loss=1e-4, grad_clip=1.0, warmup_steps=2, total_steps=10)
S, CACHE_LEN, DECODE_STEPS = 12, 16, 4


def _cfgs():
    return get_config("whisper").reduced(), jax_get_config("whisper").reduced()


@functools.cache
def _reference():
    """The reference's weights, inputs and outputs (numpy): train logits,
    prefill logits, caches and ``enc_kv`` (its ``encoder_forward``'s),
    each decode step's token, logits and caches, a train state at step 1
    and the loss's gradient at its parameters."""
    cfg, jcfg = _cfgs()
    jp = jax.jit(jax_init_params, static_argnums=0)(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32),
             "frames": rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"tree": jax.tree.map(np.asarray, jp), "batch": batch,
           "train": np.asarray(jax.jit(lambda p, b: jax_forward_train(jcfg, p, b))(jp, jb))}
    logits, caches, enc_kv = jax.jit(lambda p, b: jax_forward_prefill(jcfg, p, b, cache_len=CACHE_LEN))(jp, jb)
    out["prefill"] = (np.asarray(logits), jax.tree.map(np.asarray, caches), tuple(np.asarray(t) for t in enc_kv))
    step, decode = jax.jit(lambda p, c, t, s, e: jax_forward_decode(jcfg, p, c, t, s, enc_kv=e)), []
    for i in range(DECODE_STEPS):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)[:, None]
        logits, caches = step(jp, caches, jnp.asarray(tok), jnp.full((2,), S + i, jnp.int32), enc_kv)
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
    loss_fn = jax.jit(jax.value_and_grad(lambda p: jax_steps.cross_entropy_loss(
        jax_forward_train(jcfg, jax_steps._cast(p, jnp.float32), jtb), jtb["labels"], TCFG["z_loss"])[0]))
    loss, grads = loss_fn(jax.tree.map(jnp.asarray, params))
    out["grads"] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


def _params():
    return from_jax_params(_cfgs()[0], _reference()["tree"], device="cpu")


def _batch():
    return {k: torch.from_numpy(v) for k, v in _reference()["batch"].items()}


def _assert_caches_close(got, want):
    assert set(got) == set(want)
    for sub in want:
        assert set(got[sub]) == set(want[sub]), sub
        for name in want[sub]:
            assert tuple(got[sub][name].shape) == want[sub][name].shape, (sub, name)
            np.testing.assert_allclose(got[sub][name].numpy(), want[sub][name], **TOL, err_msg=f"{sub}/{name}")


def test_config_copy_and_layout_match_reference():
    for cfg, jcfg in ((get_config("whisper"), jax_get_config("whisper")), _cfgs()):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.n_params() == jcfg.n_params()
    cfg, _ = _cfgs()

    def layout(tree):
        return {k: layout(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tree.items()}

    ours = init_params(cfg, seed=0, device="cpu")
    assert layout(ours) == jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), _reference()["tree"])
    assert set(ours["encoder"]) == {"layers", "final_norm", "frame_proj"}
    assert {"cross", "cross_norm"} <= set(ours["layers"]) and "cross" not in ours["encoder"]["layers"]


@pytest.mark.parametrize("num_pos,d_model", [(24, 64), (1500, 1280), (5, 3)])
def test_sinusoidal_positions_match_reference(num_pos, d_model):
    """Float32 within the frequencies' rounding: XLA's exp and PyTorch's
    differ by one ulp on some of them (below 1), and each angle multiplies
    it by its position."""
    got = sinusoidal_positions(num_pos, d_model)
    want = np.asarray(jax.jit(jax_sinusoidal_positions, static_argnums=(0, 1))(num_pos, d_model))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=(num_pos + 1) * 2.0 ** -23)


def test_cross_attention_matches_reference():
    """``attention(kv=...)`` dense and blockwise (a chunk that leaves a
    tail), and ``cross_decode_attention``: q from ``x @ wq``, no rotary
    embedding, every key seen."""
    rng = np.random.default_rng(5)
    h, kv, hd, d = 4, 2, 16, 64
    p = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, h * hd)), ("wk", (d, kv * hd)), ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    ek, ev = (rng.standard_normal((2, 21, kv, hd)).astype(np.float32) for _ in range(2))
    tp, jp = {n: torch.from_numpy(a) for n, a in p.items()}, {n: jnp.asarray(a) for n, a in p.items()}
    kw = dict(num_heads=h, num_kv=kv, head_dim=hd, rope_theta=0.0, chunk=8)
    ref = jax.jit(lambda p_, x_, k_, v_, blockwise: jax_attn.attention(
        p_, x_, positions=jnp.arange(7), kv=(k_, v_), force_blockwise=blockwise, **kw), static_argnums=4)
    for blockwise in (False, True):
        want = ref(jp, jnp.asarray(x), jnp.asarray(ek), jnp.asarray(ev), blockwise)
        got = attn.attention(tp, torch.from_numpy(x), positions=torch.arange(7),
                             kv=(torch.from_numpy(ek), torch.from_numpy(ev)), force_blockwise=blockwise, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dims = dict(num_heads=h, num_kv=kv, head_dim=hd)
    want = jax.jit(functools.partial(jax_attn.cross_decode_attention, **dims))(
        jp, jnp.asarray(x[:, :1]), jnp.asarray(ek), jnp.asarray(ev))
    got = attn.cross_decode_attention(tp, torch.from_numpy(x[:, :1]), torch.from_numpy(ek), torch.from_numpy(ev), **dims)
    assert tuple(got.shape) == (2, 1, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_encoder_forward_matches_reference():
    cfg, _ = _cfgs()
    ek, ev = encoder_forward(cfg, _params(), _batch()["frames"])
    want = _reference()["prefill"][2]
    assert tuple(ek.shape) == want[0].shape == (cfg.num_layers, 2, cfg.encoder_seq, cfg.num_kv_heads, 16)
    np.testing.assert_allclose(ek.numpy(), want[0], **TOL)
    np.testing.assert_allclose(ev.numpy(), want[1], **TOL)


def test_forward_train_matches_reference():
    logits = forward_train(_cfgs()[0], _params(), _batch()).detach().numpy()
    want = _reference()["train"]
    assert logits.shape == want.shape == (2, S, 256)
    np.testing.assert_allclose(logits, want, **TOL)
    np.testing.assert_array_equal(logits.argmax(-1), want.argmax(-1))


def test_forward_prefill_and_decode_match_reference():
    """Prefill: logits, every cache and ``enc_kv``; then decode steps with
    the sinusoidal position of each new token and cross-attention over
    ``enc_kv``."""
    cfg, _ = _cfgs()
    ref, params = _reference(), _params()
    logits, caches, enc_kv = forward_prefill(cfg, params, _batch(), cache_len=CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], **TOL)
    _assert_caches_close(caches, ref["prefill"][1])
    for got, want in zip(enc_kv, ref["prefill"][2]):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    for i, (tok, want_logits, want_caches) in enumerate(ref["decode"]):
        logits, caches = forward_decode(cfg, params, caches, torch.from_numpy(tok), torch.full((2,), S + i),
                                        enc_kv=enc_kv)
        np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
        np.testing.assert_array_equal(logits.numpy().argmax(-1), want_logits.argmax(-1))
        _assert_caches_close(caches, want_caches)


def test_train_step_matches_reference():
    """One ``make_train_step`` from a converted state at step 1: its loss
    and grad norm are the reference's loss and the norm of its gradient at
    the state's parameters, and every leaf of the gradient
    (``loss_and_grads``) is the reference's within ``STEP_TOL``,
    those of ``encoder.frame_proj``, the encoder's layers and
    the decoder's ``cross`` among them (the encoder's reach it through
    ``enc_kv``, under remat)."""
    cfg, _ = _cfgs()
    assert cfg.remat
    ref = _reference()
    want_loss, want_g = ref["grads"]
    state = from_jax_train_state(cfg, ref["start"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["train_batch"].items()}
    loss, _, grads = loss_and_grads(cfg, TrainConfig(**TCFG), state["params"], batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    got_g = to_numpy(grads)
    for part in (got_g["encoder"]["frame_proj"], got_g["encoder"]["layers"]["attn"]["wq"],
                 got_g["layers"]["cross"]["wk"], got_g["layers"]["cross"]["wq"]):
        assert float(np.abs(part).max()) > 0
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got_g), jax.tree.leaves(want_g)):
        np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=f"grad{jax.tree_util.keystr(path)}")
    state, metrics = make_train_step(cfg, TrainConfig(**TCFG))(state, batch)
    want_norm = np.sqrt(sum(np.sum(np.square(w.astype(np.float64))) for w in jax.tree.leaves(want_g)))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)
    assert int(state["step"]) == 2 and all(bool(torch.isfinite(t).all()) for t in tree_leaves(state["params"]))


def test_decode_without_enc_kv_skips_cross_attention():
    """As in the reference, a decode step without ``enc_kv`` skips the
    cross branch: the serving engine feeds tokens only."""
    cfg, _ = _cfgs()
    params = _params()
    tok, pos = torch.tensor([[3], [7]]), torch.tensor([0, 5])
    plain, _ = forward_decode(cfg, params, init_caches(cfg, 2, 8, device="cpu"), tok, pos)
    no_cross = dict(params, layers={k: v for k, v in params["layers"].items() if k not in ("cross", "cross_norm")})
    same, _ = forward_decode(cfg, no_cross, init_caches(cfg, 2, 8, device="cpu"), tok, pos)
    assert torch.equal(plain, same)
    engine = ServingEngine(cfg, params, batch=2, max_seq=32, device="cpu")
    for uid in range(3):
        engine.submit(Request(uid=uid, prompt=np.arange(1, 9 + uid, dtype=np.int32), max_new_tokens=3, topk=8))
    assert engine.run_until_done().ok()
    assert sorted(engine.done) == [0, 1, 2] and all(len(r.generated) == 3 for r in engine.done.values())


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_sampler_row_holds_every_round_on_the_cpu():
    """``chip_smoke.sampler_row`` on a row wide enough for K4's rounds (5000
    pads to 8192: S1 at chunk 512, 4 rounds): on CPU tensors each plain
    version against itself, and the last round's order is the top-k's."""
    logits = torch.randn((1, 5000), generator=torch.Generator().manual_seed(0)).bfloat16()
    row = _smoke().sampler_row(logits, "a CPU row", on_card=False)
    assert (row["m"], row["chunk"], row["rounds"], row["max_abs_err"]) == (8192, 512, 4, 0)
    assert row["s1"]["ms"] is None and row["k4"]["bound_ms"] > 0


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s phase 13 on CPU tensors at the reduced size:
    every check it makes on the card passes here against the plain
    versions, and nothing is launched."""
    reset_launches()
    out = _smoke().phase_vlm_audio(device="cpu", reduce=True, text=40, new_tokens=3, step_prompt=8,
                                   vlm_train_text=24, audio_batch=2, audio_prompt=4, audio_cache=16, audio_new=3,
                                   audio_train=(2, 12), steps=2, gelu_n=4096)
    assert out["paligemma"]["k4_launches"] == 0 and out["whisper"]["s1_launches"] == 0
    assert out["paligemma"]["gelu"]["act"]["share"] == 0.0 and out["whisper"]["train"]["ms"] is None
    assert all(fn.launches == 0 for fn in WRAPPERS)
