"""The port's training path against the JAX reference.

The optimizer, the loss, the data pipeline, the checkpoint layout and the
train step of reduced falcon-mamba, each against its twin in ``repro``.
Inputs are made with numpy from a seed and handed to both packages; the
train state goes from the reference to the port through
``repro_torch.convert.from_jax_train_state``.  Float32 throughout; the
tolerances, stated per test, cover sums taken in another order (and, for
the fused scan, the kernels' plain versions against the Pallas kernels in
interpret mode).
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

from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import base as jax_base
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jax_pipeline
from repro.optim import adamw as jax_adamw
from repro.runtime import fault_tolerance as jax_ft
from repro.train import steps as jax_steps
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES, ShapeConfig, TrainConfig, get_config
from repro_torch.configs import base as port_base
from repro_torch.convert import from_jax_train_state, to_numpy
from repro_torch.data import PipelineConfig, SyntheticLMPipeline, make_batch_specs
from repro_torch.kernels import WRAPPERS, reset_launches
from repro_torch.launch import train as launch_train
from repro_torch.models import forward_train
from repro_torch.optim import adamw
from repro_torch.runtime import StragglerMonitor, TrainLoopSupervisor
from repro_torch.train import cross_entropy_loss, init_train_state, make_train_step
from repro_torch.train import smoke
from repro_torch.train.steps import loss_and_grads

OPT_TOL = dict(rtol=1e-6, atol=1e-7)  # one AdamW step: elementwise float32, one rounding apart
STEP_TOL = dict(rtol=1e-5, atol=1e-5)  # a whole train step: the model's sums in another order
TCFG = dict(z_loss=1e-4, grad_clip=1.0, warmup_steps=2, total_steps=10)


def _tree(rng, shapes):
    return {k: _tree(rng, v) if isinstance(v, dict) else rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _assert_tree_close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64), np.asarray(want[k], np.float64), **tol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# configs, optimizer, loss
# ---------------------------------------------------------------------------


def test_train_and_shape_config_copies_match_reference():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(jax_base.TrainConfig())
    assert [dataclasses.asdict(s) for s in SHAPES] == [dataclasses.asdict(s) for s in jax_base.SHAPES]
    assert port_base.SHAPES_BY_NAME["train_4k"] == ShapeConfig("train_4k", 4096, 256, "train")
    cfg, jcfg = get_config("falcon-mamba"), jax_get_config("falcon-mamba")
    shape = port_base.SHAPES_BY_NAME["train_4k"]
    assert make_batch_specs(cfg, shape) == jax_pipeline.make_batch_specs(jcfg, jax_base.SHAPES_BY_NAME["train_4k"])


@pytest.mark.parametrize("warmup,total", [(100, 1000), (0, 1), (10, 60)])
def test_cosine_schedule_matches_reference(warmup, total):
    tc, jtc = TrainConfig(warmup_steps=warmup, total_steps=total), jax_base.TrainConfig(warmup_steps=warmup, total_steps=total)
    steps = [0, 1, warmup // 2, warmup, warmup + 1, (warmup + total) // 2, total, total + 5]
    got = [float(adamw.cosine_schedule(tc, torch.tensor(s, dtype=torch.int32))) for s in steps]
    want = [float(jax_adamw.cosine_schedule(jtc, jnp.asarray(s, jnp.int32))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])  # clipped, and left alone
def test_adamw_update_matches_reference(max_norm):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 4)}}
    params, grads, m, v = (_tree(rng, shapes) for _ in range(4))
    v = {k: (np.abs(x) if not isinstance(x, dict) else {kk: np.abs(xx) for kk, xx in x.items()}) for k, x in v.items()}
    tc = TrainConfig(grad_clip=max_norm, warmup_steps=3, total_steps=20)
    jtc = jax_base.TrainConfig(grad_clip=max_norm, warmup_steps=3, total_steps=20)
    update = jax.jit(jax_adamw.adamw_update, static_argnums=0)
    jp, jo, jm = update(jtc, params, grads, {"m": m, "v": v}, jnp.asarray(4, jnp.int32))
    tp, to, tm = adamw.adamw_update(tc, _t(params), _t(grads), {"m": _t(m), "v": _t(v)}, torch.tensor(4, dtype=torch.int32))
    _assert_tree_close(to_numpy(tp), _np(jp), **OPT_TOL)
    _assert_tree_close(to_numpy(to), _np(jo), **OPT_TOL)
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-6)
    _assert_tree_close(to_numpy(adamw.init_opt_state(_t(params))), _np(jax_adamw.init_opt_state(params)), rtol=0, atol=0)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    grads = _tree(rng, {"a": (4, 4), "b": {"c": (9,)}})
    jg, jn = jax_adamw.clip_by_global_norm(grads, 0.5)
    tg, tn = adamw.clip_by_global_norm(_t(grads), 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(adamw.global_norm(_t(grads))), float(jax_adamw.global_norm(grads)), rtol=1e-6)
    _assert_tree_close(to_numpy(tg), _np(jg), **OPT_TOL)


@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_with_masked_labels_matches_reference(z_loss):
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 7, 33)) * 3).astype(np.float32)
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    labels[0, 2:4] = -1
    labels[1, -1] = -1
    jl, jm = jax.jit(jax_steps.cross_entropy_loss, static_argnums=2)(jnp.asarray(logits), jnp.asarray(labels), z_loss)
    tl, tm = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels), z_loss)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    for k in ("ce", "z_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6, atol=1e-9)
    all_masked = np.full_like(labels, -1)
    tl, _ = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(all_masked), z_loss)
    assert float(tl) == 0.0  # the denominator is at least 1


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", [True, False])
def test_pipeline_batches_match_reference(pack, monkeypatch):
    # the reference's merge sort, jitted: on int keys jit changes no result
    # (ROADMAP.md R4 is about float signed zeros) and it saves the eager
    # per-op compiles
    from repro.core import merge_sort_kv as jax_merge_sort_kv

    monkeypatch.setattr(jax_pipeline, "merge_sort_kv", jax.jit(jax_merge_sort_kv))
    cfg, jcfg = get_config("falcon-mamba").reduced(), jax_get_config("falcon-mamba").reduced()
    pcfg = dict(seed=3, host_id=1, pack=pack, mean_doc_len=16)
    ours = SyntheticLMPipeline(cfg, 3, 40, PipelineConfig(**pcfg))
    ref = jax_pipeline.SyntheticLMPipeline(jcfg, 3, 40, jax_pipeline.PipelineConfig(**pcfg))
    for step in (0, 5):
        got, want = ours.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == np.int32 and got[k].shape == (3, 40)
            np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(next(iter(ours))["tokens"], ours.batch_at(0)["tokens"])


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _cfgs(backend):
    return (dataclasses.replace(get_config("falcon-mamba").reduced(), ssm_backend=backend),
            dataclasses.replace(jax_get_config("falcon-mamba").reduced(), ssm_backend=backend))


def _batch(seq=36):
    tok = np.random.default_rng(0).integers(0, 256, (2, seq)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tok, "labels": labels}


def _start_state(jcfg):
    """A train state in the reference's layout at step 1, made with numpy:
    weights scaled by their fan-in, norm scales and moments small."""
    rng = np.random.default_rng(4)
    like = jax.eval_shape(lambda: jax_steps.init_train_state(jcfg, jax_base.TrainConfig(), jax.random.key(0)))

    def fill(s, scale):
        return (rng.standard_normal(s.shape) * scale(s)).astype(s.dtype)

    params = jax.tree.map(lambda s: fill(s, lambda t: 1 / np.sqrt(t.shape[-2] if t.ndim > 2 else 10)), like["params"])
    opt = {"m": jax.tree.map(lambda s: fill(s, lambda t: 1e-3), like["params"]),
           "v": jax.tree.map(lambda s: np.abs(fill(s, lambda t: 1e-4)), like["params"])}
    return {"step": np.ones((), np.int32), "params": params, "opt": opt}


@functools.cache
def _reference_run(backend: str, microbatch: int, steps: int):
    """The reference's train step (jitted; the fused scan's Pallas kernels in
    interpret mode) from :func:`_start_state`: per step, the state and the
    metrics, as numpy."""
    _, jcfg = _cfgs(backend)
    jtc = jax_base.TrainConfig(microbatch=microbatch, **TCFG)
    state = jax.tree.map(jnp.asarray, _start_state(jcfg))
    step = jax.jit(jax_steps.make_train_step(jcfg, jtc))
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    out = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        out.append((jax.tree.map(np.asarray, state), {k: float(v) for k, v in metrics.items()}))
    return out


@pytest.mark.parametrize("backend", ["fused", "scan"])
def test_two_train_steps_match_reference(backend):
    """Loss, grad norm, parameters and moments after each of two steps from
    the converted state, against the reference's fused-scan step."""
    cfg, jcfg = _cfgs(backend)
    ref = _reference_run("fused", 0, 2)
    state = from_jax_train_state(cfg, _start_state(jcfg), device="cpu")
    step = make_train_step(cfg, TrainConfig(**TCFG))
    for want_state, want_metrics in ref:
        state, metrics = step(state, _batch())
        assert set(metrics) == set(want_metrics)
        for k, v in want_metrics.items():
            np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, err_msg=k)
        got = to_numpy(state)
        assert int(got["step"]) == int(want_state["step"])
        _assert_tree_close(got["params"], want_state["params"], **STEP_TOL)
        _assert_tree_close(got["opt"], want_state["opt"], **STEP_TOL)


def test_microbatch_step_matches_reference():
    """Two microbatches of one row each, accumulated and divided by 2, give
    the reference's whole-batch step: each row has the same count of
    unmasked labels, so the mean of the two means is the batch's mean."""
    cfg, jcfg = _cfgs("fused")
    want_state, want_metrics = _reference_run("fused", 0, 2)[0]
    state = from_jax_train_state(cfg, _start_state(jcfg), device="cpu")
    state, metrics = make_train_step(cfg, TrainConfig(microbatch=2, **TCFG))(state, _batch())
    assert set(metrics) == {"loss", "grad_norm", "lr"}  # as the reference's microbatch step reports
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), want_metrics[k], rtol=1e-5, err_msg=k)
    _assert_tree_close(to_numpy(state)["params"], want_state["params"], **STEP_TOL)
    _assert_tree_close(to_numpy(state)["opt"], want_state["opt"], **STEP_TOL)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        make_train_step(cfg, TrainConfig(microbatch=3))(state, _batch())


def test_remat_changes_no_gradient_and_every_leaf_trains():
    """The per-layer remat recomputes the forward (so the fused path runs the
    forward scan twice per layer) and gives the gradients of the plain stack."""
    cfg, _ = _cfgs("fused")
    state = init_train_state(cfg, TrainConfig(), seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(20).items()}
    calls = []

    def count(fn):
        def wrapped(*args, **kw):
            calls.append(args[6])  # _forward(dt, x, bmat, cmat, a, chunk, checkpoints)
            return fn(*args, **kw)
        return wrapped

    from repro_torch.kernels import ssm_scan as ks

    fwd = ks._forward
    ks._forward = count(fwd)
    try:
        _, _, g_remat = loss_and_grads(cfg, TrainConfig(), state["params"], batch)
    finally:
        ks._forward = fwd
    assert calls == [True] * (2 * cfg.num_layers)
    _, _, g_plain = loss_and_grads(dataclasses.replace(cfg, remat=False), TrainConfig(), state["params"], batch)
    _assert_tree_close(to_numpy(g_remat), to_numpy(g_plain), rtol=0, atol=0)
    report = smoke.leaf_report(g_remat)
    assert report and all(f and z for _, f, z in report)


def test_layer_gradients_are_stacked_once():
    """Each stacked layer parameter reaches the layers through one ``unbind``,
    so the backward stacks the layers' gradients once; a per-layer select
    would hand every layer a zero gradient the size of the stack to sum."""
    from repro_torch.models.transformer import _dtype
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.steps import _cast

    cfg, _ = _cfgs("fused")
    params = _cast(init_train_state(cfg, TrainConfig(), seed=0, device="cpu")["params"], _dtype(cfg))
    stacked = {id(t): t.requires_grad_() for t in tree_leaves(params["layers"])}
    logits = forward_train(cfg, params, {k: torch.from_numpy(v) for k, v in _batch(20).items()})
    consumers = {}  # id of a stacked leaf -> the types of the nodes that take its gradient
    seen, todo = set(), [logits.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and id(getattr(nxt, "variable", None)) in stacked:
                consumers.setdefault(id(nxt.variable), []).append(type(node).__name__)
            todo.append(nxt)
    assert set(consumers) == set(stacked)
    assert all(c == ["UnbindBackward0"] for c in consumers.values()), consumers


def test_paths_the_slice_leaves_out_raise():
    # every compression of the reference is ported; a method it does not know raises
    cfg, _ = _cfgs("fused")
    state = init_train_state(cfg, TrainConfig(grad_compression="topk"), device="cpu")
    assert set(state) == {"step", "params", "opt", "err"}
    step = make_train_step(cfg, TrainConfig(grad_compression="fp8"))
    batch = {"tokens": np.ones((1, 8), np.int32), "labels": np.ones((1, 8), np.int32)}
    with pytest.raises(ValueError, match="grad_compression"):
        step(dict(state), batch)
    with pytest.raises(SystemExit):
        launch_train.main(["--grad-compression", "fp8", "--device", "cpu"])


# ---------------------------------------------------------------------------
# checkpoints, runtime, entry points
# ---------------------------------------------------------------------------


def test_checkpoint_written_by_reference_restores_in_the_port(tmp_path):
    cfg, jcfg = _cfgs("fused")
    jstate = jax.tree.map(jnp.asarray, _start_state(jcfg))
    jstate["step"] = jnp.asarray(7, jnp.int32)
    JaxCheckpointManager(str(tmp_path)).save(7, jstate)
    like = init_train_state(cfg, TrainConfig(), seed=0, device="cpu")
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 7
    got = mgr.restore(like)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    _assert_tree_close(to_numpy(got), jax.tree.map(np.asarray, jstate), rtol=0, atol=0)


def test_checkpoint_written_by_the_port_restores_in_reference(tmp_path):
    cfg, jcfg = _cfgs("fused")
    state = init_train_state(cfg, TrainConfig(), seed=2, device="cpu")
    state["step"].fill_(4)
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (2, 3, 4):
        mgr.save(step, state, blocking=False)
    mgr.wait()
    assert mgr.all_steps() == [3, 4]  # keep-N
    like = jax.eval_shape(lambda: jax_steps.init_train_state(jcfg, jax_base.TrainConfig(), jax.random.key(0)))
    got = JaxCheckpointManager(str(tmp_path)).restore(like)
    _assert_tree_close(jax.tree.map(np.asarray, got), to_numpy(state), rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"step": torch.zeros(2)})


def test_runtime_copies_behave_like_reference():
    times = [1.0] * 6 + [5.0, 1.0] + [9.0] * 5
    ours, ref = StragglerMonitor(patience=2), jax_ft.StragglerMonitor(patience=2)
    assert [ours.record(t) for t in times] == [ref.record(t) for t in times]
    assert ours.should_remesh() == ref.should_remesh()

    def drive(sup):
        log, armed = [], {"on": True}

        def step(s):
            if s == 3 and armed["on"]:
                armed["on"] = False
                raise RuntimeError("injected")
            log.append(("step", s))

        final = sup.run(0, 6, step, lambda s: log.append(("save", s)), lambda: 2)
        return final, log, sup.failures

    assert drive(TrainLoopSupervisor(checkpoint_every=2)) == drive(jax_ft.TrainLoopSupervisor(checkpoint_every=2))


def test_train_smoke_and_launcher_run_on_the_cpu(tmp_path, capsys):
    assert smoke.main(["--device", "cpu"]) == 0
    args = ["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert launch_train.main(args + ["--inject-failure-at", "5"]) == 0
    out = capsys.readouterr().out
    assert "[recovery] restored step 4" in out and "done at step 6" in out
    assert CheckpointManager(str(tmp_path)).latest_step() == 6
    assert launch_train.main(args + ["--steps", "7", "--resume"]) == 0
    assert "resumed from step 6" in capsys.readouterr().out


def test_chip_phase_runs_on_the_cpu():
    """``chip_smoke.phase_train`` at a tiny size on the CPU: every check of the
    training phase runs on the plain versions, and nothing is launched."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    reset_launches()
    out = chip.phase_train(device="cpu", reduce=True, shapes=((1, 40),), d=24, st=8, edges=((2, 9, 16, 8),),
                           fn_shape=(1, 20, 8, 4), layers=2, seq=36, steps=2, cmp_layers=2, cmp_seq=20)
    assert out["launches"] == 0 and out["ms"] is None and out["max_abs_err"] == 0.0
    assert all(fn.launches == 0 for fn in WRAPPERS)
