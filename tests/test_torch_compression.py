"""Gradient compression of the port against the reference's.

``repro_torch.parallel.compression`` against ``repro.parallel.compression``
jitted on the CPU, bit for bit: ``topk`` (the merge-path top-k on leaves of
at most 65,536 elements, the quantile threshold past it) and ``int8``, over
three steps of error feedback; ROADMAP R12's threshold on seeded draws; the
compressed train step of reduced tinyllama against the reference's; and the
launcher with ``--grad-compression``, its error state restored from a
checkpoint.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.parallel import compression as jax_comp
from repro.train import steps as jax_steps
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.convert import from_jax_train_state, to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.parallel import compression
from repro_torch.train import init_train_state, make_train_step

# leaves on both sides of the top-k's size rule: the stacked norms of tinyllama-1.1b (45,056 elements) take the
# merge-path top-k, 70,000 the quantile threshold
SHAPES = {"b": {"c": (70000,), "d": (22, 2048)}}
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # a whole train step, as tests/test_torch_train.py holds it
TCFG = dict(z_loss=1e-4, grad_clip=1.0, warmup_steps=2, total_steps=10)


def _tree(rng, shapes):
    return {k: _tree(rng, v) if isinstance(v, dict) else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _bits(tree):
    return [np.asarray(x).view(np.int32) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_compress_grads_is_bit_identical_to_reference_over_three_steps(method):
    rng = np.random.default_rng(0)
    ref = jax.jit(lambda g, e: jax_comp.compress_grads(g, e, method, 0.01))
    err_j = jax_comp.init_error_state(_tree(rng, SHAPES))
    err_t = compression.init_error_state(jax.tree.map(torch.from_numpy, _tree(rng, SHAPES)))
    for _ in range(3):
        grads = _tree(rng, SHAPES)
        comp_j, err_j = ref(grads, err_j)
        comp_t, err_t = compression.compress_grads(jax.tree.map(torch.from_numpy, grads), err_t, method, 0.01)
        for got, want in ((comp_t, comp_j), (err_t, err_j)):
            for g, w in zip(_bits(to_numpy(got)), _bits(want)):
                np.testing.assert_array_equal(g, w)
    assert compression.compress_grads(err_t, err_t, "none", 0.01) == (err_t, err_t)
    with pytest.raises(ValueError, match="grad_compression"):
        compression.compress_grads(err_t, err_t, "fp8", 0.01)


def test_quantile_threshold_matches_jnp_quantile_bit_for_bit():
    """ROADMAP R12: XLA contracts jnp.quantile's interpolation into one
    fused multiply-add; the port rounds the exact value once."""
    rng = np.random.default_rng(7)
    quantile = jax.jit(lambda a, q: jnp.quantile(a, q))
    for _ in range(10):
        n = int(rng.integers(65537, 1 << 18))
        frac = float(rng.uniform(0.01, 0.3))
        a = np.abs(rng.standard_normal(n) * rng.uniform(1e-3, 10)).astype(np.float32)
        a[rng.integers(0, n, 50)] = a[0]  # ties
        want = np.asarray(quantile(a, 1.0 - frac))
        got = compression.quantile_threshold(torch.from_numpy(a), frac).numpy()
        assert got.view(np.int32) == want.view(np.int32), (n, frac, got, want)
    a = np.ones(70000, np.float32)
    a[3] = np.nan
    assert np.isnan(compression.quantile_threshold(torch.from_numpy(a), 0.01).item())


def _cfgs():
    return get_config("tinyllama").reduced(), jax_get_config("tinyllama").reduced()


def _start_state(jcfg, jtc):
    rng = np.random.default_rng(4)
    like = jax.eval_shape(lambda: jax_steps.init_train_state(jcfg, jtc, jax.random.key(0)))
    state = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.05).astype(s.dtype), like)
    state["opt"]["v"] = jax.tree.map(np.abs, state["opt"]["v"])
    state["step"] = np.ones((), np.int32)
    return state


def _err_close(got, want, what):
    """The error state at the step's tolerance, but for elements whose int8
    rounding flipped: the two frameworks' gradients agree within the
    tolerance, not bit for bit, so an element at a rounding boundary may
    round to the next integer in one of them, which moves its residual by
    one quantization step (about twice the largest residual)."""
    bad = ~np.isclose(got, want, **STEP_TOL)
    assert bad.mean() <= 1e-3, f"{what}: {int(bad.sum())} of {bad.size} elements differ"
    assert np.all(np.abs(got - want)[bad] <= 2.02 * np.abs(want).max()), what


def test_compressed_train_step_matches_reference():
    """int8 compression in the train step against the reference's (the
    compressors themselves are bit-identical, above; top-k's step is the
    same wiring, driven by the launcher below)."""
    method = "int8"
    cfg, jcfg = _cfgs()
    jtc = jax_base.TrainConfig(grad_compression=method, **TCFG)
    start = _start_state(jcfg, jtc)
    assert "err" in start
    jstep = jax.jit(jax_steps.make_train_step(jcfg, jtc))
    jstate = jax.tree.map(jnp.asarray, start)
    state = from_jax_train_state(cfg, start, device="cpu")
    step = make_train_step(cfg, TrainConfig(grad_compression=method, **TCFG))
    tok = np.random.default_rng(1).integers(0, 256, (2, 24)).astype(np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=1)}
    for _ in range(2):
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, metrics = step(state, batch)
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
        got, want = to_numpy(state), jax.tree.map(np.asarray, jstate)
        assert set(got) == set(want) == {"step", "params", "opt", "err"}
        for part in ("params", "opt", "err"):
            for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got[part]), jax.tree.leaves(want[part])):
                what = f"{part}{jax.tree_util.keystr(path)}"
                if part == "err":
                    _err_close(g, w, what)
                else:
                    np.testing.assert_allclose(g, w, **STEP_TOL, err_msg=what)


def test_launcher_trains_compressed_and_restores_the_error_state(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "1", "--grad-compression", "topk"]
    assert launch_train.main(args) == 0
    assert "done at step 1" in capsys.readouterr().out
    cfg = dataclasses.replace(get_config("tinyllama").reduced(), ssm_backend="fused",
                              moe_dispatch="merge_path_pallas")
    like = init_train_state(cfg, TrainConfig(grad_compression="topk"), device="cpu")
    restored = CheckpointManager(str(tmp_path)).restore(like)
    assert int(restored["step"]) == 1
    err = list(jax.tree.leaves(to_numpy(restored["err"])))
    assert len(err) == len(jax.tree.leaves(to_numpy(like["params"]))) and any(np.any(e != 0) for e in err)
    assert launch_train.main(args + ["--steps", "2", "--resume"]) == 0
    assert "resumed from step 1" in capsys.readouterr().out
