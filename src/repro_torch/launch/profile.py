"""Where a token's time goes: one decode step and one top-k sample, traced.

    PYTHONPATH=src python -m repro_torch.launch.profile

Runs on the card only.  For full-width tinyllama-1.1b with random weights,
at the serving shapes of ``chip_smoke.py`` (batch 2, max_seq 64), it
prints, per phase (one decode step, one top-k sample of one vocab row
through the K4 path):

* wall ms per call (host clock, ended by ``torch.cuda.synchronize()``);
* device busy ms per call: the sum of CUDA kernel and copy times that
  ``torch.profiler`` records, and the idle share ``1 - busy / wall``;
* host us per launch: wall time over the number of device activities;
* the top device activities by total time.

Where the profiler records no device time, it says "not measured".
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import forward_decode, init_caches, init_params
from repro_torch.serving import topk_sample
from repro_torch.telemetry import WALL

ARCH, BATCH, MAX_SEQ, ITERS = "tinyllama-1.1b", 2, 64, 5


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


if __name__ == "__main__":
    main()
