"""The port's MoE family over whole models against the JAX reference.

Reduced moonshot (a shared expert, 4 experts top-2) and phi3.5-moe (4
experts top-2): ``forward_prefill`` of a 40-token prompt with its
caches, and decode after it (and moonshot's ``forward_train``), within
``atol = rtol = 1e-4`` with greedy tokens equal; one moonshot train step from a
converted state within ``STEP_TOL``.  Both packages get the same random
float32 weights, made with numpy from a seed and handed over through
``repro_torch.convert`` (the router float32, as the reference's tree
has it).  The reference runs jitted; each of its outputs is computed
once per module.  Then the configs, the train smoke's MoE half, the
launchers' dispatch and ``chip_smoke.py``'s MoE phase on the CPU.
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

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.models import abstract_params as jax_abstract_params
from repro.models import forward_decode as jax_forward_decode
from repro.models import forward_prefill as jax_forward_prefill
from repro.models import forward_train as jax_forward_train
from repro.train import steps as jax_steps
from repro_torch.configs import ALIASES, TrainConfig, get_config, list_archs
from repro_torch.convert import from_jax_params, from_jax_train_state, to_numpy
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import forward_decode, forward_prefill, forward_train, init_params
from repro_torch.models import moe
from repro_torch.train import make_train_step, smoke

TOL = dict(atol=1e-4, rtol=1e-4)
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # a whole train step: the model's sums in another order
TCFG = dict(z_loss=1e-4, grad_clip=1.0, warmup_steps=2, total_steps=10)
ARCHS = ("moonshot", "phi35-moe")
PROMPT, CACHE_LEN, DECODE_STEPS = 40, 44, 2


def _cfgs(arch):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


def _weights(jcfg, rng):
    """Random float32 weights in the reference's layout, scaled by fan-in."""
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(s.shape[-2] if s.ndim > 2 else 10))
                        .astype(s.dtype), jax_abstract_params(jcfg))


@functools.cache
def _reference(arch):
    """The reference's train logits, prefill logits and caches, and each
    decode step's logits (numpy), with the weights and tokens."""
    _, jcfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    tree = _weights(jcfg, rng)
    tokens = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, tree)
    train = None
    if arch == "moonshot":  # one arch's: the training forward runs the prefill's stack, caches aside
        train = np.asarray(jax.jit(lambda p, t: jax_forward_train(jcfg, p, {"tokens": t}))(jp, tokens))
    logits, caches, _ = jax.jit(lambda p, t: jax_forward_prefill(jcfg, p, {"tokens": t}, cache_len=CACHE_LEN))(
        jp, tokens)
    prefill = (np.asarray(logits), jax.tree.map(np.asarray, caches))
    decode, step = [], jax.jit(lambda p, c, t, s: jax_forward_decode(jcfg, p, c, t, s))
    for i in range(DECODE_STEPS):
        tok = np.asarray(logits).argmax(-1).astype(np.int32)[:, None]
        logits, caches = step(jp, caches, jnp.asarray(tok), jnp.full((2,), PROMPT + i, jnp.int32))
        decode.append((tok, np.asarray(logits)))
    return {"tree": tree, "tokens": tokens, "train": train, "prefill": prefill, "decode": decode}


def _params(arch):
    return from_jax_params(_cfgs(arch)[0], _reference(arch)["tree"], device="cpu")


def test_forward_train_matches_reference():
    arch = "moonshot"
    ref = _reference(arch)
    params = _params(arch)
    assert params["layers"]["moe"]["router"].dtype == torch.float32 and "mlp" not in params["layers"]
    logits = forward_train(_cfgs(arch)[0], params, {"tokens": torch.from_numpy(ref["tokens"])})
    np.testing.assert_allclose(logits.detach().numpy(), ref["train"], **TOL)
    np.testing.assert_array_equal(logits.detach().numpy().argmax(-1), ref["train"].argmax(-1))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    cfg, _ = _cfgs(arch)
    ref = _reference(arch)
    params = _params(arch)
    logits, caches, _ = forward_prefill(cfg, params, {"tokens": torch.from_numpy(ref["tokens"])}, cache_len=CACHE_LEN)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"][0], **TOL)
    np.testing.assert_array_equal(logits.numpy().argmax(-1), ref["prefill"][0].argmax(-1))
    assert set(caches["sub0"]) == set(ref["prefill"][1]["sub0"]) == {"k", "v"}
    for name, want in ref["prefill"][1]["sub0"].items():
        np.testing.assert_allclose(caches["sub0"][name].numpy(), want, **TOL, err_msg=name)
    for i, (tok, want) in enumerate(ref["decode"]):
        logits, caches = forward_decode(cfg, params, caches, torch.from_numpy(tok), torch.full((2,), PROMPT + i))
        np.testing.assert_allclose(logits.numpy(), want, **TOL)
        np.testing.assert_array_equal(logits.numpy().argmax(-1), want.argmax(-1))


def test_train_step_matches_reference():
    """One moonshot train step (the routing sort on the kernel route's plain
    versions) from a converted state: loss, metrics, new parameters and
    moments against the reference's jitted step."""
    cfg, jcfg = (dataclasses.replace(c, moe_dispatch="merge_path_pallas") for c in _cfgs("moonshot"))
    jcfg = dataclasses.replace(jcfg, moe_dispatch="merge_path")  # the same sort; the reference's core route traces faster
    rng = np.random.default_rng(4)
    params = _weights(jcfg, rng)
    opt = {"m": jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3).astype(np.float32), params),
           "v": jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape) * 1e-4).astype(np.float32), params)}
    start = {"step": np.ones((), np.int32), "params": params, "opt": opt}
    tok = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tok, "labels": labels}
    jstate, jmetrics = jax.jit(jax_steps.make_train_step(jcfg, jax_base.TrainConfig(**TCFG)))(
        jax.tree.map(jnp.asarray, start), {k: jnp.asarray(v) for k, v in batch.items()})
    state, metrics = make_train_step(cfg, TrainConfig(**TCFG))(from_jax_train_state(cfg, start, device="cpu"), batch)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    got, want = to_numpy(state), jax.tree.map(np.asarray, jstate)
    assert int(got["step"]) == int(want["step"])
    for part in ("params", "opt"):
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got[part]), jax.tree.leaves(want[part])):
            np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=f"{part}{jax.tree_util.keystr(path)}")


def test_configs_and_aliases_match_reference():
    """Both MoE configs field for field, full and reduced, under the
    reference's aliases; the family's layers hold ``moe`` and no ``mlp``."""
    for alias in ("moonshot", "phi35-moe", "phi3.5-moe"):
        cfg, jcfg = get_config(alias), jax_get_config(alias)
        assert ALIASES[alias] == cfg.name and cfg.name in list_archs()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(jcfg.reduced())
        assert cfg.n_params() == jcfg.n_params() and cfg.n_active_params() == jcfg.n_active_params()
    layers = init_params(get_config("moonshot").reduced(), seed=0, device="cpu")["layers"]
    assert set(layers) == {"attn_norm", "attn", "moe", "ffn_norm"}
    assert set(layers["moe"]) == {"router", "wg", "wi", "wo", "shared"}


def test_train_smoke_moe_half_and_the_launchers_use_the_kernel_route(tmp_path, monkeypatch):
    """The smoke's phi3.5-moe half (512 slots: one S1 chunk a layer) trains
    every leaf; ``launch.train`` and ``launch.serve`` route a MoE config on
    ``"merge_path_pallas"``."""
    cfg = dataclasses.replace(get_config("phi35-moe").reduced(), moe_dispatch="merge_path_pallas")
    assert smoke.smoke_one("phi3.5-moe/merge-path-pallas", cfg, batch=1, seq=256, device="cpu")
    backends = []
    real = moe._positions_merge_path_batched

    def spy(flat, e, slot_lens=None, backend="core"):
        backends.append(backend)
        return real(flat, e, slot_lens, backend)

    monkeypatch.setattr(moe, "_positions_merge_path_batched", spy)
    assert launch_train.main(["--arch", "moonshot", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
                              "--ckpt-dir", str(tmp_path), "--ckpt-every", "5"]) == 0
    assert backends and set(backends) == {"pallas"}
    backends.clear()
    launch_serve.main(["--arch", "phi3.5-moe", "--device", "cpu", "--requests", "1", "--max-new", "2"])
    assert backends and set(backends) == {"pallas"}


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.py``'s MoE phase on CPU tensors at the reduced size: every
    check it makes on the card passes here against the plain versions (the
    prefill's 600 slots a layer run S1's and one K4 round's), and nothing
    is launched."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    reset_launches()
    out = chip.phase_moe(device="cpu", reduce=True, prompt=300, new_tokens=3, step_prompt=6, train_layers=2,
                         train_seq=24, steps=2, grad_seq=32, phi_layers=2, phi_prompt=40, phi_new=3)
    assert out["sort_round_kv"]["launches"] == 0 and out["sort_tiles_kv"]["ms"] is None
    assert out["sort_round_kv"]["max_abs_err"] == 0 and out["train_ms"] is None
    assert all(fn.launches == 0 for fn in WRAPPERS)
