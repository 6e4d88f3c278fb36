"""Batched serving command line on the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 6 --batch 2 --max-new 8 [--device cpu]

Like the reference's ``repro.launch.serve`` it serves the reduced config
of ``--arch`` (tinyllama-1.1b, yi-6b, gemma3-12b, hymba-1.5b,
falcon-mamba-7b, moonshot-v1-16b-a3b, phi3.5-moe-42b-a6.6b, paligemma-3b
or whisper-large-v3, or their aliases; the last two on tokens alone, as
the reference's engine serves them) with random weights from a seed, MoE routing on the kernel sort
(``moe_dispatch="merge_path_pallas"``: S1 and K4);
``--device`` picks the device (the card by default).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving.engine import Request, ServingEngine
from repro_torch.telemetry import WALL


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).reduced(), moe_dispatch="merge_path_pallas")
    params = init_params(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, batch=args.batch, max_seq=args.max_seq, device=args.device)

    rng = np.random.default_rng(0)
    t0 = WALL.now()
    for uid in range(args.requests):
        plen = int(rng.integers(4, 12))
        prompt = rng.integers(1, cfg.vocab_size, size=plen).astype(np.int32)
        engine.submit(Request(uid=uid, prompt=prompt, max_new_tokens=args.max_new,
                              temperature=args.temperature))
    report = engine.run_until_done()
    dt = (WALL.now() - t0) / 1e6
    total_tokens = sum(len(r.generated) for r in engine.done.values())
    print(f"served {len(engine.done)} requests on {engine.device}, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s), ok={report.ok()}")
    for uid in sorted(engine.done):
        print(f"  req {uid}: {engine.done[uid].generated}")


if __name__ == "__main__":
    main()
