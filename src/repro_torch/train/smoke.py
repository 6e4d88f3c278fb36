"""Kernel-path training smoke: ``python -m repro_torch.train.smoke [--device cpu]``.

The reference's ``repro/train/smoke.py``: one real
:func:`~repro_torch.train.steps.make_train_step` step (loss, backward, AdamW
update) of each of two reduced configs, on the kernels (their plain
versions on the CPU):

* falcon-mamba with ``ssm_backend="fused"``, so that the forward runs K9
  and the backward K10.  The sequence (36) straddles the checkpoint
  interval, so the short last tile is part of the trained graph;
* phi3.5-moe with ``moe_dispatch="merge_path_pallas"``, so that the
  routing sort runs on the tile sort S1.  Its 256 tokens of 2 experts are
  512 slots a row: with the port's tile of 512 (``kernels/tune.py``) that
  is one S1 launch per layer and no K4 round (the reference's comment
  about "the flat merge round" is about its own 256-key int tile).

For each it asserts that

1. the step's loss is finite;
2. the gradient of the same loss is finite and nonzero on every parameter
   leaf (a dead leaf means a route silently detached);
3. the update moved the parameters.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import TrainConfig, get_config
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.steps import init_train_state, loss_and_grads, make_train_step


def fake_batch(seed: int, batch: int, seq: int, vocab: int):
    """Random tokens from a numpy seed; the labels are the next tokens, the
    last position masked."""
    tok = np.random.default_rng(seed).integers(0, vocab, (batch, seq)).astype(np.int32)
    labels = np.roll(tok, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tok, "labels": labels}


def leaf_report(tree, prefix: str = "") -> List[Tuple[str, bool, bool]]:
    """``(path, finite, nonzero)`` per leaf."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += leaf_report(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", bool(torch.isfinite(v).all()), bool((v != 0).any())))
    return out


def smoke_one(name: str, cfg, *, batch: int, seq: int, seed: int = 0, device=None) -> bool:
    tcfg = TrainConfig(z_loss=1e-4, grad_clip=1.0)
    state = init_train_state(cfg, tcfg, seed=seed, device=device)
    dev = state["step"].device
    # the linear warmup is exactly 0 at step 0; start mid-warmup so a
    # zero-lr first step cannot mask a dead backward
    state["step"] = torch.ones((), dtype=torch.int32, device=dev)
    data = {k: torch.as_tensor(v, device=dev) for k, v in fake_batch(seed, batch, seq, cfg.vocab_size).items()}

    # per-leaf gradient audit of the same loss the step uses
    loss0, _, grads = loss_and_grads(cfg, tcfg, state["params"], data)
    report = leaf_report(grads)
    bad = [(n, f, z) for n, f, z in report if not (f and z)]
    del grads

    before = [p.clone() for p in tree_leaves(state["params"])]
    state, metrics = make_train_step(cfg, tcfg)(state, data)
    loss = float(metrics["loss"])
    moved = any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(state["params"])))

    ok = bool(np.isfinite(float(loss0)) and np.isfinite(loss) and not bad and moved)
    print(f"[train-smoke] {name}: loss={loss:.4f} leaves={len(report)} "
          f"all_finite_nonzero={not bad} params_moved={moved} -> {'ok' if ok else 'FAIL'}")
    for n, f, z in bad:
        print(f"  BAD LEAF {n}: finite={f} nonzero={z}")
    return ok


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    # SSM on the fused scan (falcon-mamba-shaped); the sequence straddles the
    # checkpoint interval, so the short last tile is part of the trained graph
    ssm = dataclasses.replace(get_config("falcon-mamba").reduced(), ssm_backend="fused")
    ok = smoke_one("falcon-mamba/fused-ssm-scan", ssm, batch=2, seq=36, device=args.device)
    # MoE on the kernel dispatch (phi3.5-moe-shaped): 256 tokens x top-2 = 512 slots, one S1 chunk
    moe = dataclasses.replace(get_config("phi35-moe").reduced(), moe_dispatch="merge_path_pallas")
    ok &= smoke_one("phi3.5-moe/merge-path-pallas", moe, batch=1, seq=256, device=args.device)
    if not ok:
        print("[train-smoke] FAILED", file=sys.stderr)
        return 1
    print("[train-smoke] all kernel-path train steps passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
