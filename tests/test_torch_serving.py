"""The port's serving engine and sampler on the CPU at reduced size.

Greedy tokens are held against the JAX reference's ``forward_decode``
argmax chain on the same weights.  The top-k sampler is held to the
softmax over the top-k candidates by frequency.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward_decode as jax_forward_decode
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params
from repro_torch.models import init_params
from repro_torch.serving import Request, ServingEngine, topk_sample
from repro_torch.serving.engine import ServingWarning

MAX_SEQ = 32


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    jparams = jax_init_params(jcfg, jax.random.key(1))
    cfg = get_config("tinyllama-1.1b").reduced()
    return cfg, jcfg, jparams, from_jax_params(cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _jax_greedy(jcfg, jparams, prompt, max_new):
    """Reference: one request alone, greedy, through the JAX decode step."""
    decode = jax.jit(lambda p, c, t, s: jax_forward_decode(jcfg, p, c, t, s))
    caches = jax_init_caches(jcfg, 1, MAX_SEQ)
    for t, tok in enumerate(prompt):
        logits, caches = decode(jparams, caches, jnp.array([[tok]], jnp.int32), jnp.array([t], jnp.int32))
    out, pos = [int(jnp.argmax(logits[0]))], len(prompt)
    while len(out) < max_new and pos < MAX_SEQ - 1:
        logits, caches = decode(jparams, caches, jnp.array([[out[-1]]], jnp.int32), jnp.array([pos], jnp.int32))
        pos += 1
        out.append(int(jnp.argmax(logits[0])))
    return out


def _requests(cfg, n, temperature, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [
        Request(uid=u, prompt=rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 8))).astype(np.int32),
                max_new_tokens=max_new, temperature=temperature)
        for u in range(n)
    ]


def test_greedy_engine_matches_reference_chain(model):
    cfg, jcfg, jparams, params = model
    engine = ServingEngine(cfg, params, batch=2, max_seq=MAX_SEQ, device="cpu")
    reqs = _requests(cfg, 3, temperature=0.0)
    for r in reqs:
        engine.submit(r)
    report = engine.run_until_done()
    assert report.ok() and report.completed == 3 and report.retries == 0
    for r in reqs:
        assert engine.done[r.uid].generated == _jax_greedy(jcfg, jparams, r.prompt, r.max_new_tokens)


def test_sampling_engine_is_seeded(model):
    cfg, params = model[0], model[3]
    runs = []
    for _ in range(2):
        engine = ServingEngine(cfg, params, batch=2, max_seq=MAX_SEQ, seed=3, device="cpu")
        for r in _requests(cfg, 3, temperature=0.8):
            engine.submit(r)
        report = engine.run_until_done()
        assert report.ok() and report.completed == 3
        runs.append({u: r.generated for u, r in engine.done.items()})
        assert all(0 <= t < cfg.vocab_size for toks in runs[-1].values() for t in toks)
    assert runs[0] == runs[1]


def test_engine_sheds_times_out_and_retries(model):
    cfg, params = model[0], model[3]
    engine = ServingEngine(cfg, params, batch=1, max_seq=MAX_SEQ, max_pending=2, device="cpu")
    reqs = _requests(cfg, 3, temperature=0.0, max_new=3)
    reqs[1].deadline_ticks = 1  # still queued behind request 0 when it expires
    fails = iter([True])
    real = engine._decode

    def flaky(token, pos):
        if next(fails, False):
            raise RuntimeError("injected decode fault")
        return real(token, pos)

    engine._decode = flaky
    with pytest.warns(ServingWarning):
        for r in reqs:
            engine.submit(r)
        report = engine.run_until_done()
    assert report.statuses == {2: "shed", 1: "timed_out", 0: "completed"}
    assert report.retries == 1 and not report.ok()


@pytest.mark.parametrize("backend,tile", [("kernel", 16), ("core", None)])
def test_topk_sample_follows_the_topk_softmax(backend, tile):
    """Frequencies of 40000 draws within 0.01 of the softmax over the top-k
    candidates (the binomial standard deviation is at most 0.0025, so the
    bound is four of them), and no draw outside the top-k."""
    rng = np.random.default_rng(0)
    v, k, temp, n = 64, 8, 0.7, 40000
    logits = torch.from_numpy(rng.standard_normal(v).astype(np.float32))
    gen = torch.Generator().manual_seed(0)
    draws = topk_sample(logits.expand(n, v).contiguous(), gen, k=k, temperature=temp, backend=backend, tile=tile)
    assert draws.dtype == torch.int32 and tuple(draws.shape) == (n,)
    top = torch.topk(logits, k).indices
    want = torch.softmax(logits[top] / temp, dim=0)
    freq = torch.bincount(draws.long(), minlength=v).float() / n
    assert float(freq.sum() - freq[top].sum()) == 0.0
    assert float((freq[top] - want).abs().max()) < 0.01


def test_engine_refuses_a_silent_cpu(monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(model[0], model[3], batch=1, max_seq=MAX_SEQ)


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "3"])
    assert "served 2 requests on cpu" in capsys.readouterr().out


def test_seeded_init_is_reproducible():
    cfg = get_config("tinyllama-1.1b").reduced()
    a, b = init_params(cfg, seed=5, device="cpu"), init_params(cfg, seed=5, device="cpu")
    assert torch.equal(a["embed"]["table"], b["embed"]["table"])
