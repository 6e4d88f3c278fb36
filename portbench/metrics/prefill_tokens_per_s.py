"""``prefill_tokens_per_s``: the prompt tokens of the requests issued in the
window, over the seconds from its start until the last of them reached the
host (host clock)."""

from portbench.harness import module


def read(run):
    w = module("metrics", "_window", run.root)
    if "requests" not in run.records or not w.on_card(run):
        return None
    done, seconds = w.served(run, "requests")
    return sum(r["len"] for r in done) / seconds
