"""``mfu.chat_prefill``: ``mfu.prefill`` of the chat cell, beside its own rate."""

from portbench.harness import module


def read(run):
    return module("metrics", "mfu.prefill", run.root).read(run)
