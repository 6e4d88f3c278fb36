"""The readings the limits of ``correct`` are set from, on the card, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds <n>... [--control-seeds <n>...]

For every seed of ``--seeds`` it prints the program's numbers (the lower
readings); for every seed of ``--control-seeds`` also the control's: the
reference put in the program's place and computed one precision below the
configuration's bfloat16, in float8 e4m3 (``reference.model.q8``), read
as the program is: its last logits and its cache; and on a prefill cell
the same reference in bfloat16, the witness of what the configuration's
own precision does to the numbers.  On a training cell
those seeds also read the faults a training cell can have: half of the
batch left out (the labels of each row's second half masked, the mean
taken over the rest) and a step that returns its state unchanged.  The benchmark's own runs do not run this.

A prefill cell reads requests as its runs would compare them: the sample
a run draws (``prefill_sample.Sample``), here from the first block of the
mix (every length once, the longest among them), served one at a time
through the timed path.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from portbench import harness, weights  # noqa: E402
from portbench.entries import prefill_sample as ps  # noqa: E402
from portbench.entries import train_step as ts  # noqa: E402
from portbench.reference import model as ref  # noqa: E402


def prefill_readings(run, control: bool):
    cfg, dev = run.config, run.device
    params = weights.make(cfg, run.seed, dev, compute=ps.compute_dtype(cfg))
    reqs = harness.module("traffic", run.mix["generator"], run.root).make(run.mix, run.seed, cfg["vocab_size"])
    serve = ps.serve_fn(run, ps.port_config(cfg), params)
    sample = ps.Sample(reqs, run.workload["check"]["requests"], run.seed)
    sample.alloc(cfg, run.workload["check"].get("cache_layers"), dev)
    logits = {}
    for i in range(len(reqs.lengths)):
        slot = sample.slot(i)
        if slot is not None:
            out, caches, _, _ = serve(reqs.tokens(i, dev), reqs.greedy(i))
            sample.keep(slot, i, caches)
            logits[i] = out[0].float()
            del caches
    ref.exact()
    detail = []
    kept = sample.kept(logits)
    out = {"program": ps.compare(cfg, params, reqs, kept, dev, detail), "program_detail": detail}
    rows = next(iter(sample.buf.values())).shape[1]
    for side, quant in (("control", "fp8"), ("witness", "bf16")) if control else ():
        other = {i: reference_side(cfg, params, reqs.tokens(i, dev), quant, rows) for i in kept}
        detail = []
        out[side] = ps.compare(cfg, params, reqs, other, dev, detail)
        out[side + "_detail"] = detail
    del params
    return out


def reference_side(cfg, params, tokens, quant, rows):
    """The reference in ``quant`` in the program's place: its last logits and
    the first ``rows`` layers of its cache, in the layout of
    :meth:`~portbench.entries.prefill_sample.Sample.kept`.  In float8 it is
    the control; in bfloat16, the program's own precision, it witnesses what
    rounding alone does to the comparison."""
    layers = {}

    def each(i, keep):
        if i < rows:
            layers[i] = {key: (keep[key][0] if key == "ssm" else keep[key]).cpu()
                         for key in ps.CACHE_KEYS[cfg["family"]]}

    logits = ref.last_logits(cfg, params, tokens, quant, each_layer=each)
    return logits, {key: torch.stack([layers[i][key] for i in sorted(layers)]) for key in ps.CACHE_KEYS[cfg["family"]]}


def half_batch(name, fn):
    def step(state, batch):
        labels = batch["labels"].clone()
        labels[:, labels.shape[1] // 2:] = -1
        return fn(state, dict(batch, labels=labels))

    return step


def unchanged(name, fn):
    """A step that returns its state unchanged (it steps a copy)."""
    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

    def step(state, batch):
        _, metrics = fn(copy(state), batch)
        return state, metrics

    return step


def train_readings(run, control: bool):
    batches = ts.batches_of(run)
    sides = {}
    faults = [("half_batch", half_batch), ("unchanged", unchanged)] if control else []
    for label, wrap in [("program", None)] + faults:
        state, step_fn, side = ts.program(run, batches, wrap)
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        sides[label] = side
    want = ts.reference(run, batches)
    if control:
        sides["control"] = ts.reference(run, batches, "fp8")
    out = {k: ts.gaps(v, want) for k, v in sides.items()}
    every = range(len(want["grad"]))
    out["leaves"] = {"reference_grad": want["grad"], "reference_change": want["change"],
                     **{f"{k}_grad": ts.leaf_gaps(v["grad"], want["grad"], every) for k, v in sides.items()}}
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = p.parse_args()
    for seed in a.seeds:
        run = harness.Run(a.workload, seed, 0.0, False)
        harness.require_card(run.chips)
        reader = train_readings if run.workload["entry"] == "train_step" else prefill_readings
        out = reader(run, seed in a.control_seeds)
        print(json.dumps({"cell": a.workload, "seed": seed, **out}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    os.environ["USE_FLAX"] = "0"
    sys.exit(main())
