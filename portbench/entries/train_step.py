"""Training steps: ``make_train_step`` on rows of packed documents.

Set-up makes the float32 masters from the seed on the card, AdamW's
moments at zero and the step at 0 in the port's layout (one state, the
one the window steps on), and drives it through its first three steps
with the window's own call on the stream's first three batches (rows
that all differ).  Those steps give the check its program side: each
step's loss, each leaf's gradient norm as AdamW took it (its first moment
after step 1 over ``1 - beta1``), and each leaf's change after step 3
(against the leaf drawn again from the seed).  Then the window dispatches
steps without waiting on them, a CUDA event after each; a step counts
when its event falls inside the window, as one synchronise at the end
settles.

The check, once the window has closed, the peak memory is read and the
program's state is freed: the plain reference (float32, TF32 off, every
layer recomputed in its backward) takes the same masters and the same
three batches, and the gaps are

* ``loss_gap``: the largest ``|loss - loss_ref| / loss_ref`` of the three steps;
* ``grad_gap``: the worst leaf's ``|norm - norm_ref|`` over the larger of
  its reference norm and the median leaf's;
* ``change_gap``: the same of the change after three steps, over the
  leaves whose reference gradient is at least a thousandth of the median
  leaf's (a leaf with none moves by round-off alone under AdamW).
"""

from __future__ import annotations

import gc
import statistics
from typing import Dict, List

import torch

from portbench import weights
from portbench.entries.prefill_sample import port_config, profiler, sync
from portbench.harness import card, clock, module
from portbench.reference import model as ref
from portbench.reference.train import Trainer

FIRST_STEPS = 3


def batches_of(run):
    cfg, mix = run.config, run.mix
    return module("traffic", mix["generator"], run.root).make(mix, run.seed, cfg["vocab_size"],
                                                              run.workload["batch"])


def program(run, batches, wrap=None):
    """The program's state after its first steps, its step function and its side of the check."""
    from repro_torch.configs import TrainConfig
    from repro_torch.optim.adamw import init_opt_state
    from repro_torch.train import make_train_step

    cfg, dev = run.config, run.device
    pc = port_config(cfg)
    step_fn = make_train_step(pc, TrainConfig(**run.workload["train"]))
    step_fn = (wrap or run.wrap)("train_step", step_fn)
    params = weights.make(cfg, run.seed, dev, masters=True)
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev), "params": params,
             "opt": init_opt_state(params)}
    b1 = run.workload["train"]["beta1"]
    losses, grads = [], None
    for i in range(FIRST_STEPS):
        state, m = step_fn(state, batches.batch_at(i, dev))
        losses.append(m["loss"])
        if i == 0:
            grads = [t.norm() / (1 - b1) for t in weights.leaves(state["opt"]["m"])]
    change = [(p - weights.leaf(cfg, run.seed, j, torch.float32, dev)).norm()
              for j, p in enumerate(weights.leaves(state["params"]))]
    side = {"loss": [float(x) for x in losses], "grad": [float(x) for x in grads], "change": [float(x) for x in change]}
    return state, step_fn, side


def reference(run, batches, quant=None) -> Dict[str, List[float]]:
    """The reference's side of the check (``quant="fp8"``: the control)."""
    cfg, dev = run.config, run.device
    ref.exact()
    trainer = Trainer(cfg, run.workload["train"], weights.make(cfg, run.seed, dev, masters=True), quant)
    losses, grads = [], None
    for i in range(FIRST_STEPS):
        b = batches.batch_at(i, dev)
        loss, g = trainer.step(b["tokens"], b["labels"])
        losses.append(loss)
        if i == 0:
            grads = [float(x.norm()) for x in g]
        del g
    with torch.no_grad():
        change = [float((p - weights.leaf(cfg, run.seed, j, torch.float32, dev)).norm())
                  for j, p in enumerate(trainer.leaves)]
    return {"loss": losses, "grad": grads, "change": change}


def leaf_gaps(got: List[float], want: List[float], keep) -> List[float]:
    """Each kept leaf's ``|norm - norm_ref|`` over the larger of its reference
    norm and the median kept leaf's."""
    med = statistics.median(want[j] for j in keep)
    return [abs(got[j] - want[j]) / max(want[j], med, 1e-30) for j in keep]


def gaps(prog: Dict[str, List[float]], want: Dict[str, List[float]]) -> Dict[str, float]:
    """The three numbers compared (see the module's doc)."""
    def worst(got, ref_, keep):
        return max(leaf_gaps(got, ref_, keep))

    every = range(len(want["grad"]))
    med_grad = statistics.median(want["grad"])
    moving = [j for j in every if want["grad"][j] >= 1e-3 * med_grad]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["loss"], want["loss"])),
            "grad_gap": worst(prog["grad"], want["grad"], every),
            "change_gap": worst(prog["change"], want["change"], moving)}


def run(run) -> None:
    dev = run.device
    if dev == "cuda":
        card(run)
    batches = batches_of(run)
    state, step_fn, side = program(run, batches)
    sync(dev)
    prof = profiler(dev, host=False) if run.trace else None
    if prof is not None:
        prof.__enter__()
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    steps = []
    timed = dev == "cuda"
    start = torch.cuda.Event(enable_timing=True) if timed else None
    t0 = clock()
    run.setup_s = t0 - run.t_start
    with torch.profiler.record_function("portbench.window"):
        if timed:
            start.record()
        i = FIRST_STEPS
        while clock() - t0 < run.seconds:
            state, m = step_fn(state, batches.batch_at(i, dev))
            ev = torch.cuda.Event(enable_timing=True) if timed else None
            if timed:
                ev.record()
            steps.append((i, m["loss"], ev, clock() - t0))
            i += 1
        sync(dev)
    if prof is not None:
        prof.__exit__(None, None, None)
        from portbench.trace import summarise

        run.trace_summary = summarise(prof) if timed else None
        del prof
    run.memory_peak_bytes = torch.cuda.max_memory_allocated() if timed else 0
    done = []
    for i, loss, ev, t_host in steps:
        t = start.elapsed_time(ev) / 1e3 if timed else t_host
        done.append({"i": i, "labels": batches.label_tokens(i), "t_done": t, "ok": bool(torch.isfinite(loss))})
    run.attempted = len(done)
    run.failed = sum(not d["ok"] for d in done)
    run.records["steps"] = done
    run.records["shape"] = (run.workload["batch"], run.mix["row"])
    del state, step_fn, steps
    gc.collect()
    if timed:
        torch.cuda.empty_cache()
    limits = run.workload["check"]["limits"]
    t = clock()
    g = gaps(side, reference(run, batches))
    run.records["check_s"] = clock() - t
    run.checks = [(name, g[name], limits[name]) for name in ("loss_gap", "grad_gap", "change_gap")]
