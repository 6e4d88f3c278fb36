#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. card: the name and power limit as ``nvidia-smi`` reports them;
2. build: every kernel under ``src/repro_torch/kernels/csrc`` with ``nvcc``;
3. K4 against its plain version on the card, bit for bit: every wide
   round of the sampler's sort (m = 32768 + 512, widths 512 ... 16384) on
   int16 and int32 keys drawn from adversarial rows, then whole top-k
   sorts at (1, 32000) and (64, 32000); with CUDA-event times of the
   kernel, the plain version and one stable ``torch.sort`` (a yardstick the
   port never calls);
4. serving: ``ServingEngine`` on tinyllama-1.1b at full width (random
   weights from a seed), 4 requests with top-k sampling; the K4 launch
   count must be 6 per sampled token.  Then the reduced config on the card
   against the same weights on the CPU;
5. the ``kernels`` line, the card line and the result line.

It imports nothing of JAX or of the JAX package, and needs one card.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
M, TILE, LEAF = 32768, 512, 32  # tinyllama's vocab 32000 pads to 32768
WIDTHS = tuple(1 << e for e in range(9, 15))  # the 6 wide rounds: 512 ... 16384
K4_SOURCE = "src/repro_torch/kernels/csrc/sort_round_kv.cu"
K4_REPLACES = "src/repro/kernels/merge_path.py:962"


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call.  A sleep kernel keeps the card busy
    while the host queues the timed calls, so host overhead between
    launches does not count."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def round_bound(m: int, key_bytes: int) -> dict:
    """Least time of one round: the m data keys and values read once and all
    m + T written once (the tail block writes constants and reads nothing),
    against the few comparisons per data element of the in-tile searches."""
    nbytes = (2 * m + TILE) * (key_bytes + 4)
    ops = m * (math.log2(LEAF) + 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / SCALAR_OPS_PER_S * 1e3
    return {"ms": max(t_bytes, t_ops), "by": "bytes" if t_bytes >= t_ops else "operations"}


def adversarial_floats(kind: str, n: int, dtype, gen):
    """One row family of logits, as the sampler sees them."""
    import torch

    x = (torch.randn(n, generator=gen, device="cuda") * 3).to(dtype)
    if kind == "logits":
        return x
    if kind == "all_equal":
        return torch.full((n,), 1.5, dtype=dtype, device="cuda")
    if kind == "dups":
        return torch.randint(-3, 4, (n,), generator=gen, device="cuda").to(dtype)
    if kind == "specials":  # -0.0, +0.0, NaNs of both signs, +-inf
        r = torch.rand(n, generator=gen, device="cuda")
        x = torch.where(r < 0.1, torch.tensor(-0.0, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.1) & (r < 0.2), torch.tensor(0.0, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.2) & (r < 0.25), torch.tensor(math.nan, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.25) & (r < 0.3), -torch.tensor(math.nan, dtype=dtype, device="cuda"), x)
        x = torch.where((r >= 0.3) & (r < 0.33), torch.tensor(math.inf, dtype=dtype, device="cuda"), x)
        return torch.where((r >= 0.33) & (r < 0.36), torch.tensor(-math.inf, dtype=dtype, device="cuda"), x)
    raise ValueError(kind)


def round_inputs(keys, width: int):
    """A flat round input: runs of ``width`` sorted stably, then the tail."""
    import torch

    from repro_torch.core.merge_path import max_sentinel

    m = keys.shape[0]
    vals = torch.arange(m, dtype=torch.int32, device="cuda")
    ks, perm = torch.sort(keys.view(-1, width), dim=1, stable=True)
    vs = torch.gather(vals.view(-1, width), 1, perm)
    kf = torch.cat([ks.reshape(-1), torch.full((TILE,), max_sentinel(keys.dtype), dtype=keys.dtype, device="cuda")])
    vf = torch.cat([vs.reshape(-1), torch.zeros((TILE,), dtype=torch.int32, device="cuda")])
    return kf, vf


def phase_k4(gen) -> dict:
    import torch

    from repro_torch.core import topk_batched as core_topk
    from repro_torch.core.merge_path import flip_desc, total_order_keys
    from repro_torch.kernels import ops
    from repro_torch.kernels.merge_path import sort_round_kv, sort_round_kv_ref

    max_err = 0
    cases = 0

    def compare(got, want, what):
        nonlocal max_err, cases
        for g, w in zip(got, want):
            check(g.dtype == w.dtype and g.shape == w.shape, f"{what}: dtype/shape {g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
            err = int((g.long() - w.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{what}: kernel differs from its plain version (max abs err {err})")
        cases += 1

    rounds = {}
    for key_dtype, float_dtype in ((torch.int16, torch.bfloat16), (torch.int32, torch.float32)):
        imax = torch.iinfo(key_dtype).max
        families = {
            kind: total_order_keys(flip_desc(adversarial_floats(kind, M, float_dtype, gen)))
            for kind in ("logits", "all_equal", "dups", "specials")
        }
        mixed = torch.randint(-1000, 1000, (M,), generator=gen, device="cuda").to(key_dtype)
        families["iinfo_max"] = torch.where(torch.rand(M, generator=gen, device="cuda") < 0.5, imax, mixed)
        families["iinfo_max_runs"] = torch.full((M,), imax, dtype=key_dtype, device="cuda")
        families["iinfo_max_runs"][: M // 4] = mixed[: M // 4]
        for kind, keys in families.items():
            check(keys.dtype == key_dtype, f"{kind}: keys are {keys.dtype}")
            for w in WIDTHS:
                kf, vf = round_inputs(keys, w)
                got = sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF)
                compare(got, sort_round_kv_ref(kf, vf, w, tile=TILE), f"{key_dtype} {kind} width {w}")
        # times on the sampler's own keys: logits in total order
        key_bytes = torch.tensor([], dtype=key_dtype).element_size()
        for w in WIDTHS:
            kf, vf = round_inputs(families["logits"], w)
            pairs = kf[:M].view(-1, 2 * w)
            rounds[(str(key_dtype), w)] = {
                "kernel_ms": time_ms(lambda: sort_round_kv(kf, vf, w, tile=TILE, leaf=LEAF)),
                "plain_ms": time_ms(lambda: sort_round_kv_ref(kf, vf, w, tile=TILE)),
                "library_ms": time_ms(lambda: torch.sort(pairs, dim=1, stable=True)),
                "bound": round_bound(M, key_bytes),
            }

    # whole sorts through the public surface: kernel path against the core path
    for bsz in (1, 64):
        rows = [adversarial_floats(("logits", "all_equal", "dups", "specials")[r % 4], 32000, torch.bfloat16, gen) for r in range(bsz)]
        x = torch.stack(rows)
        for k in (40, 32000):
            compare(ops.topk_batched(x, k), core_topk(x, k), f"topk_batched ({bsz}, 32000) k={k}")
    torch.cuda.synchronize()

    print("K4 per round (m=32768+512, T=512, S=32; CUDA events):")
    for (kd, w), r in rounds.items():
        print(f"  {kd:12s} width {w:5d}: kernel_ms {r['kernel_ms']:.5f}  plain_ms {r['plain_ms']:.5f}  "
              f"library_ms {r['library_ms']:.5f}  bound_ms {r['bound']['ms']:.6f} ({r['bound']['by']})")
    main_path = [r for (kd, _), r in rounds.items() if kd == str(torch.int16)]
    print(f"K4: {cases} comparisons against the plain version, tolerance 0 (bit-identical), max abs err {max_err}")
    return {
        "max_abs_err": max_err,
        "ms": sum(r["kernel_ms"] for r in main_path),
        "plain_ms": sum(r["plain_ms"] for r in main_path),
        "library_ms": sum(r["library_ms"] for r in main_path),
        "bound_ms": sum(r["bound"]["ms"] for r in main_path),
        "bound_by": main_path[0]["bound"]["by"],
    }


def phase_serving() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.merge_path import sort_round_kv
    from repro_torch.models import forward_decode, init_caches, init_params
    from repro_torch.serving import Request, ServingEngine, topk_sample

    cfg = get_config("tinyllama-1.1b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"serving: {cfg.name} full width ({cfg.num_layers} layers, d={cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}), {n_bytes / 1e9:.3f} GB of weights from seed 0 in {time.perf_counter() - t0:.2f} s")
    engine = ServingEngine(cfg, params, batch=2, max_seq=64, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    for uid in range(4):
        prompt = rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 12))).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=8, temperature=0.8, topk=40))
    sort_round_kv.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = engine.run_until_done()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = sort_round_kv.launches

    tokens = [t for r in engine.done.values() for t in r.generated]
    check(report.ok(), f"serving report not ok: {report.statuses} {report.reasons}")
    check(report.retries == 0, f"serving retried {report.retries} ticks: {report.reasons}")
    check(report.completed == 4 and len(engine.done) == 4, f"completed {report.completed} of 4")
    check(all(0 <= t < cfg.vocab_size for t in tokens), f"token out of range: {tokens}")
    check(launches == 6 * len(tokens), f"K4 launched {launches} times for {len(tokens)} sampled tokens (want 6 each)")
    print(f"serving: 4 requests, {len(tokens)} sampled tokens in {seconds:.3f} s "
          f"({seconds * 1e3 / len(tokens):.2f} ms/token, prefill included), K4 launches {launches}")

    # breakdown at the same shapes: one lockstep decode step, one sampled token
    caches = init_caches(cfg, 2, 64, device="cuda")
    tok = torch.ones((2, 1), dtype=torch.int64, device="cuda")
    pos = torch.zeros(2, dtype=torch.int64, device="cuda")
    logits, _ = forward_decode(cfg, params, caches, tok, pos)
    check(tuple(logits.shape) == (2, cfg.vocab_size) and bool(torch.isfinite(logits.float()).all()), "decode logits not finite")
    step_ms = time_ms(lambda: forward_decode(cfg, params, caches, tok, pos), iters=10)
    sgen = torch.Generator(device="cuda")
    sample_ms = time_ms(lambda: topk_sample(logits[:1], sgen, k=40, temperature=0.8, backend="kernel"), iters=10)
    print(f"serving: decode step (batch 2) {step_ms:.3f} ms, one top-k sample (1, 32000) {sample_ms:.3f} ms (CUDA events)")
    del params, engine, caches
    torch.cuda.empty_cache()
    return {"launches": launches, "tokens": len(tokens), "ms_per_token": seconds * 1e3 / len(tokens)}


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def phase_reference() -> None:
    """The reduced config on the card against the same weights on the CPU."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import topk_batched as core_topk
    from repro_torch.kernels import ops
    from repro_torch.models import forward_decode, init_caches, init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("tinyllama-1.1b").reduced()  # float32, 2 layers, d=64, vocab 256
    cpu = init_params(cfg, seed=0, device="cpu")
    gpu = {"embed": {"table": cpu["embed"]["table"].cuda()}, "final_norm": cpu["final_norm"].cuda(),
           "layers": _to(cpu["layers"], "cuda")}
    caches = {dev: init_caches(cfg, 2, 16, device=dev) for dev in ("cpu", "cuda")}
    tok = torch.tensor([[3], [7]])
    for t in range(4):
        pos = torch.full((2,), t)
        lc, _ = forward_decode(cfg, cpu, caches["cpu"], tok, pos)
        lg, _ = forward_decode(cfg, gpu, caches["cuda"], tok.cuda(), pos.cuda())
        # float32 sums run in another order on the card: 1e-4 covers it
        check(torch.allclose(lg.cpu(), lc, atol=1e-4, rtol=1e-4), f"reduced logits differ at step {t}: {float((lg.cpu() - lc).abs().max())}")
        check(torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), f"greedy tokens differ at step {t}")
        tok = lc.argmax(-1, keepdim=True)
    vals, idx = ops.topk_batched(lg, 40, tile=128)  # vocab 256 at tile 128: one K4 round
    cv, ci = core_topk(lg.cpu(), 40)
    check(torch.equal(idx.cpu(), ci) and torch.equal(vals.cpu(), cv), "reduced top-k differs from the CPU core path")
    print("reference: reduced tinyllama on the card matches the CPU within 1e-4 over 4 decode steps; top-k identical")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")

    t0 = time.perf_counter()
    lib = _build.build("sort_round_kv")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    k4 = phase_k4(gen)
    serving = phase_serving()
    phase_reference()

    kernels = [{
        "name": "sort_round_kv", "route": "cuda", "source": K4_SOURCE, "replaces": K4_REPLACES,
        "launches": serving["launches"], "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"], "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"],
    }]
    print("times: ms, plain_ms, library_ms and bound_ms of K4 are the sums over the 6 wide rounds of one sampled token")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
