"""End-to-end training loop on the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 60 --batch 8 --seq 64 [--device cpu]

The reference's ``repro.launch.train`` loop: data pipeline -> train step
-> checkpoint cadence -> restart on failure (the supervisor) -> straggler
report.  It trains the reduced config of ``--arch`` by default
(``--no-reduced`` for the published widths: tinyllama-1.1b, yi-6b,
gemma3-12b, hymba-1.5b, falcon-mamba-7b, moonshot-v1-16b-a3b,
phi3.5-moe-42b-a6.6b or paligemma-3b; like the reference's, the loop feeds
tokens alone, so paligemma trains without its prefix and
whisper-large-v3, which needs frames, does not train here), with Mamba heads on the fused selective scan (K9
forward, K10 backward) and MoE routing on the kernel sort
(``moe_dispatch="merge_path_pallas"``: S1 and K4), on the card unless
``--device cpu``.  ``--grad-compression topk`` or ``int8`` compresses
the gradients with error feedback; the error state is checkpointed with
the rest of the state.
Checkpoints go to ``build/train_ckpt`` under the checkout unless
``--ckpt-dir`` names another directory.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data.pipeline import PipelineConfig, SyntheticLMPipeline
from repro_torch.runtime.fault_tolerance import StragglerMonitor, TrainLoopSupervisor
from repro_torch.telemetry import wall_seconds
from repro_torch.train.steps import init_train_state, make_train_step

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--no-reduced", dest="reduced", action="store_false")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--grad-compression", default="none", choices=["none", "topk", "int8"])
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="simulate a crash at this step (tests the restart path)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, ssm_backend="fused", moe_dispatch="merge_path_pallas")
    tcfg = TrainConfig(
        learning_rate=args.lr,
        warmup_steps=10,
        total_steps=args.steps,
        microbatch=args.microbatch,
        grad_compression=args.grad_compression,
        checkpoint_every=args.ckpt_every,
        checkpoint_dir=args.ckpt_dir,
    )
    pipe = SyntheticLMPipeline(cfg, args.batch, args.seq, PipelineConfig(seed=tcfg.seed))
    mgr = CheckpointManager(tcfg.checkpoint_dir, keep=3)
    state = init_train_state(cfg, tcfg, seed=tcfg.seed, device=args.device)
    start_step = 0
    if args.resume and mgr.latest_step() is not None:
        state = mgr.restore(state)
        start_step = int(state["step"])
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(cfg, tcfg)
    straggler = StragglerMonitor()
    holder = {"state": state}
    inject = {"armed": args.inject_failure_at >= 0}

    def one_step(step: int) -> None:
        if inject["armed"] and step == args.inject_failure_at:
            inject["armed"] = False
            raise RuntimeError("injected failure (simulated node loss)")
        batch = pipe.batch_at(step)
        t0 = wall_seconds()
        holder["state"], metrics = step_fn(holder["state"], batch)
        loss = float(metrics["loss"])  # waits for the step to finish on the device
        dt = wall_seconds() - t0
        if straggler.record(dt):
            print(f"[straggler] step {step} took {dt:.3f}s")
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} ({dt * 1e3:.0f} ms)")

    def save(step: int) -> None:
        mgr.save(step, holder["state"], blocking=False)

    def restore() -> int:
        mgr.wait()
        latest = mgr.latest_step()
        if latest is None:
            holder["state"] = init_train_state(cfg, tcfg, seed=tcfg.seed, device=args.device)
            return 0
        holder["state"] = mgr.restore(holder["state"])
        print(f"[recovery] restored step {latest}")
        return latest

    sup = TrainLoopSupervisor(checkpoint_every=tcfg.checkpoint_every)
    final = sup.run(start_step, args.steps, one_step, save, restore)
    mgr.wait()
    mgr.save(final, holder["state"], blocking=True)
    if torch.device(args.device).type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    print(f"done at step {final} on {args.device}; checkpoints in {tcfg.checkpoint_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
