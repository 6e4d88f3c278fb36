"""``mfu.prefill``: the operations of the requests issued in the window
(``portbench.counts.prefill_flops``) over the seconds until the last was
done times the card's bfloat16 peak, in %."""

from portbench import counts
from portbench.harness import module


def read(run):
    w = module("metrics", "_window", run.root)
    if "requests" not in run.records or not w.on_card(run):
        return None
    done, seconds = w.served(run, "requests")
    return 100.0 * sum(counts.prefill_flops(run.config, r["len"]) for r in done) / (
        seconds * counts.PEAKS["bf16_flops"])
