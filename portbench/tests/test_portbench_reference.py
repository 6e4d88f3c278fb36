"""The plain reference against the port's plain paths at tiny widths, and what
the reference and the harness import."""

import ast
import dataclasses
import subprocess
import sys

import pytest
import torch

import portbench_tiny as tiny
from portbench import harness, weights
from portbench.reference import model as ref
from portbench.reference import scan as rscan
from portbench.reference.train import Trainer

ROOT = harness.ROOT


def _port_cfg(cfg):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(cfg["port"]["arch"]), **cfg["port"]["options"])


@pytest.mark.parametrize("cfg", [tiny.MOE, tiny.SSM], ids=["phi-moe", "falcon-mamba"])
def test_last_logits_match_the_port(cfg):
    from repro_torch.train import make_prefill_step

    params = weights.make(cfg, 11, "cpu", compute=torch.float32)
    tokens = torch.randint(1, cfg["vocab_size"], (37,), generator=torch.Generator().manual_seed(3))
    got, caches = make_prefill_step(_port_cfg(cfg))(params, {"tokens": tokens[None]})
    layers = {}
    want = ref.last_logits(cfg, params, tokens, each_layer=lambda i, keep: layers.update({i: keep}))
    assert torch.allclose(got[0], want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    ps = harness.module("entries", "prefill_sample")
    sample = ps.Sample(type("Reqs", (), {"lengths": [37], "length": lambda self, i: 37})(), 1, 0)
    sample.alloc(cfg, None, "cpu")
    sample.keep(0, 0, caches)
    _, cache = sample.kept({0: got[0]})[0]
    for i, keep in layers.items():  # the prefill's cache, one row a layer, as the reference keeps it
        for key in ps.CACHE_KEYS[cfg["family"]]:
            w = keep[key][0] if key == "ssm" else keep[key]
            assert torch.allclose(cache[key][i], w, rtol=1e-4, atol=1e-5 * float(w.abs().max())), (i, key)


def test_train_steps_match_the_port():
    from repro_torch.configs import TrainConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train import make_train_step

    cfg = tiny.SSM
    settings = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10, weight_decay=0.1, beta1=0.9, beta2=0.95,
                    eps=1e-8, grad_clip=1.0, z_loss=1e-4)
    params = weights.make(cfg, 5, "cpu", masters=True)
    state = {"step": torch.zeros((), dtype=torch.int32), "params": params, "opt": init_opt_state(params)}
    step = make_train_step(_port_cfg(cfg), TrainConfig(**settings))
    trainer = Trainer(cfg, settings, weights.make(cfg, 5, "cpu", masters=True))
    gen = torch.Generator().manual_seed(9)
    for _ in range(2):
        tokens = torch.randint(1, cfg["vocab_size"], (2, 24), generator=gen)
        labels = torch.where(torch.rand((2, 24), generator=gen) < 0.8, torch.roll(tokens, -1, 1), -1)
        state, m = step(state, {"tokens": tokens, "labels": labels})
        loss, _ = trainer.step(tokens, labels)
        assert float(m["loss"]) == pytest.approx(loss, rel=1e-5)
    for got, want in zip(weights.leaves(state["params"]), trainer.leaves):
        assert torch.allclose(got, want.detach(), rtol=1e-4, atol=1e-6)


def test_blocked_scan_against_steps(monkeypatch):
    monkeypatch.setattr(rscan, "BLOCK", 16)
    monkeypatch.setattr(rscan, "CHUNK", 4)
    g = torch.Generator().manual_seed(1)
    b, s, d, n = 2, 37, 6, 4
    dt = torch.rand((b, s, d), generator=g, dtype=torch.float64) * 0.5
    x, bm, cm = (torch.randn(shape, generator=g, dtype=torch.float64) for shape in ((b, s, d), (b, s, n), (b, s, n)))
    a = -torch.rand((d, n), generator=g, dtype=torch.float64) * 4
    y, h, _ = rscan.scan_forward(dt, x, bm, cm, a)
    y1, h1 = rscan.scan_steps(dt, x, bm, cm, a)
    assert torch.allclose(y, y1) and torch.allclose(h, h1)
    ins = [t.clone().requires_grad_() for t in (dt, x, bm, cm, a)]
    dy = torch.randn((b, s, d), generator=g, dtype=torch.float64)
    grads = torch.autograd.grad((rscan.Scan.apply(*ins) * dy).sum(), ins)
    ins1 = [t.clone().requires_grad_() for t in (dt, x, bm, cm, a)]
    want = torch.autograd.grad((rscan.scan_steps(*ins1)[0] * dy).sum(), ins1)
    for got, w in zip(grads, want):
        assert torch.allclose(got, w, rtol=1e-9, atol=1e-10)


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names.add("<dynamic>")
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "portbench/reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, path


def test_harness_sources_import_no_jax():
    for path in (ROOT / "portbench").rglob("*.py"):
        if "tests" not in path.parts:
            assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("jax", "jax.numpy", "repro", "repro.core", "flax", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, sys)
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    found = harness.forbidden_modules()
    assert {"jax", "jaxlib", "flax", "repro"} <= set(found) and "repro_torch_x" not in found


def test_loaded_modules_in_a_run_process():
    """What a run's process loads, by whole top-level names (``repro_torch`` is allowed, ``repro`` not)."""
    code = ("import sys; sys.argv = ['x']; sys.path[:0] = ['src', '.'];"
            "import portbench.reference.model, portbench.reference.train, portbench.harness as h;"
            "import portbench.entries.prefill_sample, portbench.entries.train_step;"
            "import repro_torch.train, repro_torch.serving;"
            "ref_only = {m.split('.')[0] for m in sys.modules};"
            "print(sorted(set(h.FORBIDDEN) & ref_only))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
