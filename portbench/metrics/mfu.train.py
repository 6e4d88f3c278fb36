"""``mfu.train``: the operations of the steps dispatched in the window
(``portbench.counts.train_flops``: 3 x forward, remat not counted) over the
seconds until the last was done times the card's bfloat16 peak, in %."""

from portbench import counts
from portbench.harness import module


def read(run):
    w = module("metrics", "_window", run.root)
    if "steps" not in run.records or not w.on_card(run):
        return None
    rows, seq = run.records["shape"]
    done, seconds = w.served(run, "steps")
    return 100.0 * len(done) * counts.train_flops(run.config, rows, seq) / (seconds * counts.PEAKS["bf16_flops"])
