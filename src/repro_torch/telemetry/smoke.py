"""Trace smoke workload: the port's ``trace-smoke``.

    PYTHONPATH=src python -m repro_torch.telemetry.smoke [--out trace.json] [--device cpu]

Serves the reduced tinyllama (random weights from a seed) 3 greedy
requests under the engine's tick clock, then runs one guarded
``distributed_merge`` of 256 + 256 sorted float32 keys on a one-rank
process group (NCCL on the card, gloo on the CPU; set up and torn down
here unless one is up), which fills the Corollary 7 balance gauge, and
writes the trace.  ``python -m repro_torch.telemetry --check <out>``
then passes: no unclosed span, a balance ratio of at most 1.05.  It runs
on the card unless ``--device cpu`` is given (the tests).
"""

from __future__ import annotations

import argparse
import socket


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="trace.json", help="trace file to write")
    ap.add_argument("--device", default=None, help="the device (the card when not given)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch._device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core import distributed_merge
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Request, ServingEngine
    from repro_torch.telemetry import Telemetry, use, write_trace

    device = resolve_device(args.device)
    cfg = get_config("tinyllama-1.1b").reduced()
    params = init_params(cfg, seed=0, device=device)
    with use(Telemetry()) as tel:
        eng = ServingEngine(cfg, params, batch=2, max_seq=32, device=device)
        rng = np.random.default_rng(0)
        for i in range(3):
            eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, 4).astype(np.int32), max_new_tokens=2,
                               temperature=0.0))
        rep = eng.run_until_done()
        if not rep.ok():
            raise RuntimeError(f"trace smoke workload degraded: {rep}")

        own_group = not dist.is_initialized()
        if own_group:
            dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                    init_method=f"tcp://localhost:{_free_port()}", world_size=1, rank=0)
        try:
            a = torch.from_numpy(np.sort(rng.standard_normal(256)).astype(np.float32)).to(device)
            b = torch.from_numpy(np.sort(rng.standard_normal(256)).astype(np.float32)).to(device)
            distributed_merge(a, b)
        finally:
            if own_group:
                dist.destroy_process_group()
        write_trace(tel, args.out)
    print(f"trace-smoke: wrote {args.out} ({rep.ticks} ticks, {rep.completed} completed, {device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
