"""Distributed Merge Path across the ranks of a process group.

    torchrun --nproc-per-node P -m repro_torch.launch.dsort [--device cpu] [--log2n 14]

The counterpart of the reference's ``examples/distributed_sort_demo.py``.
Each rank draws the same global arrays from a seed, keeps its ceil-div
shard, and prints:

* the distributed merge of two sorted arrays of ``2^log2n`` float32 keys:
  its segments sorted, the window exchange equal to the gather exchange,
  and the exchange bytes per rank of each (``exchange_bytes``);
* the sample sort of ``2^(log2n + 1)`` float32 keys (the local sort on the
  kernels, ``local_sort="kernel"``): every bucket sorted, the valid
  prefixes in rank order the whole array sorted, the bucket counts and the
  overflow flag;
* the distributed top-k of the same keys against ``torch.topk``.

By default it runs on the card: NCCL, one rank per card
(``torch.cuda.set_device(LOCAL_RANK)``).  ``--device cpu`` takes gloo and
CPU tensors.  Without a card and without ``--device cpu`` it raises.
torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``
and ``MASTER_PORT``; inside a process group that is already up,
:func:`main` uses it and leaves it up.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch._device import resolve_device
from repro_torch.core import (
    distributed_merge,
    distributed_sort,
    distributed_topk,
    exchange_bytes,
    merge_sort,
)


def _shard(x: torch.Tensor, p: int, i: int) -> torch.Tensor:
    """Rank ``i``'s ceil-div shard of ``x``."""
    n = x.shape[0]
    m = -(-n // p)
    return x[min(i * m, n) : min((i + 1) * m, n)]


def _gathered(x: torch.Tensor, p: int) -> list:
    """Every rank's 1-D ``x`` (lengths may differ), in rank order."""
    lens = [torch.zeros(1, dtype=torch.int64, device=x.device) for _ in range(p)]
    dist.all_gather(lens, torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device))
    width = max(int(n.item()) for n in lens)
    out = [torch.empty(width, dtype=x.dtype, device=x.device) for _ in range(p)]
    dist.all_gather(out, torch.cat([x, x.new_zeros(width - x.shape[0])]))
    return [o[: int(n.item())] for o, n in zip(out, lens)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log2n", type=int, default=14)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dev = torch.device("cuda", torch.cuda.current_device())
    try:
        p, rank = dist.get_world_size(), dist.get_rank()
        rng = np.random.default_rng(args.seed)
        n = 1 << args.log2n
        a = torch.from_numpy(np.sort(rng.standard_normal(n).astype(np.float32))).to(dev)
        b = torch.from_numpy(np.sort(rng.standard_normal(n).astype(np.float32))).to(dev)
        x = torch.from_numpy(rng.standard_normal(2 * n).astype(np.float32)).to(dev)

        window = distributed_merge(_shard(a, p, rank), _shard(b, p, rank))
        gather = distributed_merge(_shard(a, p, rank), _shard(b, p, rank), exchange="gather")
        merged = torch.cat(_gathered(window, p))
        merge_ok = bool(torch.equal(window, gather)) and bool((merged[1:] >= merged[:-1]).all())
        eb = exchange_bytes(n, n, p, 4)

        out, count, overflow = distributed_sort(_shard(x, p, rank), local_sort="kernel")
        buckets = _gathered(out[: int(count.item())], p)
        counts = [int(c.shape[0]) for c in buckets]
        sort_ok = bool(torch.equal(torch.cat(buckets), merge_sort(x))) and not bool(overflow)

        vals, idx = distributed_topk(_shard(x, p, rank), args.k)
        ref_vals, ref_idx = torch.topk(x, args.k)
        topk_ok = bool(torch.equal(vals, ref_vals)) and bool(torch.equal(idx.long(), ref_idx))

        report = {"ranks": p, "merge_ok": merge_ok, "sort_ok": sort_ok, "topk_ok": topk_ok, "counts": counts,
                  "overflow": bool(overflow), "window_payload": eb["window_payload"], "gather": eb["gather"]}
        if rank == 0:
            print(f"dsort: {p} ranks on {dev.type} ({dist.get_backend()})")
            print(f"distributed_merge of 2 x {n}: sorted and window == gather: {merge_ok}; bytes per rank "
                  f"{eb['window_payload']} (window payload), {eb['window_wire_padded']} (window wire), "
                  f"{eb['gather']} (gather)")
            print(f"distributed_sort of {2 * n} (local sort on the kernels): sorted {sort_ok}, bucket counts "
                  f"{counts}, overflow {bool(overflow)}")
            print(f"distributed_topk k={args.k} against torch.topk: {topk_ok}; values {vals[:4].tolist()} ...")
            print("dsort OK" if merge_ok and sort_ok and topk_ok else "dsort FAILED")
        return report
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    rep = main()
    raise SystemExit(0 if rep["merge_ok"] and rep["sort_ok"] and rep["topk_ok"] else 1)
