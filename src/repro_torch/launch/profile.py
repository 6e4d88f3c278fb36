"""Where a token's time goes: decode steps, samples and a prefill, traced.

    PYTHONPATH=src python -m repro_torch.launch.profile

Runs on the card only.  For full-width tinyllama-1.1b with random weights,
at the serving shapes of ``chip_smoke.py`` (batch 2, max_seq 64): one
decode step and one top-k sample of one vocab row through the K4 path.
Then for full-width falcon-mamba-7b (fused scan, random weights), at the
shapes of ``chip_smoke.py``'s SSM phase: one ``make_prefill_step`` of a
(1, 32768) prompt (64 K9 launches) and one ``make_decode_step`` with its
top-k sample.  It prints, per phase:

* wall ms per call (host clock, ended by ``torch.cuda.synchronize()``);
* device busy ms per call: the sum of CUDA kernel and copy times that
  ``torch.profiler`` records, and the idle share ``1 - busy / wall``;
* host us per launch: wall time over the number of device activities;
* the top device activities by total time.

Where the profiler records no device time, it says "not measured".
"""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import forward_decode, init_caches, init_params
from repro_torch.models.transformer import _dtype
from repro_torch.serving import topk_sample
from repro_torch.telemetry import WALL
from repro_torch.train import make_decode_step, make_prefill_step
from repro_torch.train.steps import _cast

ARCH, BATCH, MAX_SEQ, ITERS = "tinyllama-1.1b", 2, 64, 5
SSM_ARCH, SSM_PROMPT = "falcon-mamba-7b", 32768


def _trace(fn, iters: int) -> dict:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = WALL.now()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    wall_ms = (WALL.now() - t0) / 1e3 / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in events) / 1e3 / iters  # profiler times are us
    top: dict = {}
    for e in events:
        top[e.name] = top.get(e.name, 0.0) + e.device_time_total / 1e3 / iters
    return {
        "wall_ms": wall_ms,
        "busy_ms": busy_ms if events else None,
        "launches": len(events) / iters,
        "top": sorted(top.items(), key=lambda kv: -kv[1])[:6],
    }


def _report(name: str, r: dict) -> None:
    if r["busy_ms"] is None:
        print(f"{name}: wall {r['wall_ms']:.3f} ms; device busy: not measured")
        return
    print(f"{name}: wall {r['wall_ms']:.3f} ms, device busy {r['busy_ms']:.3f} ms, "
          f"idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}, {r['launches']:.0f} device activities, "
          f"host {r['wall_ms'] * 1e3 / max(1.0, r['launches']):.1f} us per activity")
    for kname, ms in r["top"]:
        print(f"    {ms:9.4f} ms  {kname[:110]}")


def main() -> None:
    cfg = get_config(ARCH)
    params = init_params(cfg, seed=0, device="cuda")
    caches = init_caches(cfg, BATCH, MAX_SEQ, device="cuda")
    tok = torch.ones((BATCH, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((BATCH,), 8, dtype=torch.int64, device="cuda")
    logits, _ = forward_decode(cfg, params, caches, tok, pos)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print(f"card: {torch.cuda.get_device_name(0)}; {cfg.name} full width, batch {BATCH}")
    _report("decode step", _trace(lambda: forward_decode(cfg, params, caches, tok, pos), ITERS))
    _report("top-k sample (1, V)", _trace(
        lambda: topk_sample(logits[:1], gen, k=40, temperature=0.8, backend="kernel"), ITERS))
    x = torch.zeros(16, device="cuda")
    _report("tiny op (x.add_(1))", _trace(lambda: x.add_(1), 200))
    del params, caches, logits

    cfg = dataclasses.replace(get_config(SSM_ARCH), ssm_backend="fused")
    params = _cast(init_params(cfg, seed=0, device="cuda"), _dtype(cfg))  # once: the steps then copy nothing
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (1, SSM_PROMPT), generator=gen, device="cuda")
    print(f"{cfg.name} full width, fused scan, prompt (1, {SSM_PROMPT})")
    _report("prefill", _trace(lambda: prefill(params, {"tokens": tokens}), 1))
    logits, caches = prefill(params, {"tokens": tokens})
    tok = torch.ones((1, 1), dtype=torch.int64, device="cuda")
    pos = torch.full((1,), SSM_PROMPT, dtype=torch.int64, device="cuda")

    def step():
        out, _ = decode(params, caches, tok, pos)
        topk_sample(out, gen, k=40, temperature=0.8, backend="kernel")

    _report("decode step with its top-k sample", _trace(step, ITERS))


if __name__ == "__main__":
    main()
