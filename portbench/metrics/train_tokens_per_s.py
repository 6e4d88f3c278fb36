"""``train_tokens_per_s``: the unmasked labels of the steps dispatched in the
window, over the seconds from its start until the last of them was done
(a CUDA event after each step, one synchronise at the end)."""

from portbench.harness import module


def read(run):
    w = module("metrics", "_window", run.root)
    if "steps" not in run.records or not w.on_card(run):
        return None
    done, seconds = w.served(run, "steps")
    return sum(s["labels"] for s in done) / seconds
